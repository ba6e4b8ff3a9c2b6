"""Overload autopilot: closed-loop SLO control over serving telemetry
(``isoforest_tpu/autopilot/controller.py``, host Python copied).

:class:`Autopilot` watches its attached scoring services' queue pressure
(pending rows / ``max_queue_rows``, the crispest leading indicator the
coalescer owns) and, under *sustained* pressure, walks an explicit,
reversible brownout ladder:

==== ============================= ==========================================
rung LADDER reason                 action
==== ============================= ==========================================
1    ``autopilot_widen_batch``     widen the live coalescer's linger/batch
                                   toward throughput
                                   (:meth:`~isoforest_tpu_torch.serving
                                   .coalescer.MicroBatchCoalescer
                                   .reconfigure`)
2    ``autopilot_shed_low_weight`` refuse tenants below the highest
                                   attached ``ServingConfig.weight`` class
                                   with a typed 429 + ``Retry-After``
3    ``autopilot_quality_degrade`` score on a ``subsample_trees`` prefix of
                                   the forest and, on the CPU, the q16
                                   plane
==== ============================= ==========================================

On a service whose model lies on the card, rung 3 applies
``subsample_trees`` alone: the port's q16 walk is torch ops there, slower
than the kernels it would replace, so it would add traversal work where
the rung means to shed it. The rung's ``degrade`` detail says so.

Every descent takes its degradation-ladder rung through
:func:`~isoforest_tpu_torch.resilience.degradation.degrade` (log-once,
counter, ``degradation`` event; ``strict=True`` refuses the rung and the
autopilot becomes report-only), emits an ``autopilot.engage`` event and
moves the ``isoforest_autopilot_rung`` gauge. Recovery is rung-by-rung
with hysteresis: pressure must sit at or below ``low_water`` for
``recover_ticks`` consecutive ticks (against ``high_water`` and
``engage_ticks`` on the way down, with a dead band between the two
watermarks) before ONE rung lifts.

The control loop is a plain ``tick()`` so tests drive it deterministically
(no real sleeps, FakeClock); ``start()`` runs the same tick from a daemon
thread every ``tick_interval_s``.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

from ..resilience.degradation import DegradationError, degrade
from ..telemetry.events import record_event
from ..telemetry.metrics import gauge as _gauge
from ..utils.logging import logger

_RUNG_GAUGE = _gauge(
    "isoforest_autopilot_rung",
    "Current overload-autopilot brownout rung (0 = full fidelity; "
    "1 = widened batching; 2 = low-weight tenants shed; 3 = quality "
    "degraded — docs/autopilot.md)",
)
_PRESSURE_GAUGE = _gauge(
    "isoforest_autopilot_pressure",
    "Queue pressure the autopilot last observed (max over attached "
    "services of pending rows / max_queue_rows)",
)

#: rung number -> the degradation-ladder reason it takes
RUNG_REASONS = (
    "autopilot_widen_batch",
    "autopilot_shed_low_weight",
    "autopilot_quality_degrade",
)


@dataclasses.dataclass
class AutopilotConfig:
    """Control-policy knobs.

    The watermarks are queue-fill fractions; ``high_water`` must exceed
    ``low_water`` — the gap is the hysteresis dead band in which the
    controller holds its rung. ``engage_ticks``/``recover_ticks`` are the
    consecutive-tick debounce on each side (recovery deliberately slower
    than descent: lifting a brownout into still-warm pressure re-browns
    immediately and thrashes every knob on the way)."""

    high_water: float = 0.5
    low_water: float = 0.15
    engage_ticks: int = 3
    recover_ticks: int = 6
    tick_interval_s: float = 0.5
    # rung 1: multiply the live coalescer policy toward throughput
    widen_batch_factor: float = 2.0
    widen_linger_factor: float = 4.0
    # rung 3: quality knobs (q16 applies on the CPU only, module doc)
    subsample_trees: float = 0.5
    force_q16: bool = True
    # opt-out: report pressure but refuse every brownout rung
    strict: bool = False

    def __post_init__(self) -> None:
        if not 0.0 < self.low_water < self.high_water <= 1.0:
            raise ValueError(
                "watermarks must satisfy 0 < low_water < high_water <= 1, "
                f"got low={self.low_water:g} high={self.high_water:g}"
            )
        if self.engage_ticks < 1 or self.recover_ticks < 1:
            raise ValueError("engage_ticks and recover_ticks must be >= 1")
        if self.widen_batch_factor < 1.0 or self.widen_linger_factor < 1.0:
            raise ValueError("widen factors must be >= 1 (rung 1 only widens)")
        if not 0.0 < self.subsample_trees <= 1.0:
            raise ValueError(
                f"subsample_trees must be in (0, 1], got {self.subsample_trees:g}"
            )
        if self.tick_interval_s <= 0:
            raise ValueError("tick_interval_s must be positive")


def _on_card(service) -> bool:
    """True when ``service`` scores on a CUDA device."""
    return service.model.device.type == "cuda"


# the process-wide active controller: GET /models and /healthz surface its
# rung without the HTTP layers holding a reference (None = no autopilot)
_ACTIVE: Optional["Autopilot"] = None
_ACTIVE_LOCK = threading.Lock()


def current_rung() -> Optional[int]:
    """The active autopilot's brownout rung, or None when no controller
    is attached to this process."""
    ap = _ACTIVE
    return ap.rung if ap is not None else None


class Autopilot:
    """The closed-loop controller (module doc). Attach EITHER a static
    ``services`` sequence (single-model deployments, tests) or a fleet
    ``registry`` (the sensor/actuator set tracks residency — tenants
    loaded after a rung engaged are browned out on the next tick).

    ``clock`` is injectable and ``start=False`` leaves the control thread
    off; tests call :meth:`tick` directly (zero real sleeps)."""

    def __init__(
        self,
        services: Optional[Sequence] = None,
        registry=None,
        config: Optional[AutopilotConfig] = None,
        clock: Callable[[], float] = time.monotonic,
        start: bool = False,
    ) -> None:
        if (services is None) == (registry is None):
            raise ValueError("pass exactly one of services= or registry=")
        self._static_services = list(services) if services is not None else None
        self._registry = registry
        self.config = config or AutopilotConfig()
        self._clock = clock
        self._lock = threading.RLock()
        self.rung = 0
        self.last_pressure = 0.0
        self.ticks = 0
        self._high_ticks = 0
        self._low_ticks = 0
        # rung 1 revert state: id(service) -> original coalescer policy
        self._original_policy: Dict[int, dict] = {}
        self._widened: Dict[int, object] = {}
        self._refused_logged = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        _RUNG_GAUGE.set(0)
        global _ACTIVE
        with _ACTIVE_LOCK:
            _ACTIVE = self
        if start:
            self.start()

    # ------------------------------------------------------------------ #
    # sensors
    # ------------------------------------------------------------------ #

    def _services(self) -> List:
        if self._static_services is not None:
            return list(self._static_services)
        return self._registry.resident_services()

    def pressure(self) -> float:
        """Queue pressure in [0, 1]: the worst attached service's queue
        fill fraction. The queue is the leading indicator — it grows the
        moment offered load exceeds drain rate, well before the latency
        histogram's percentiles catch up."""
        worst = 0.0
        for service in self._services():
            coalescer = service.coalescer
            cap = max(int(coalescer.max_queue_rows), 1)
            worst = max(worst, coalescer.pending_rows / cap)
        return worst

    # ------------------------------------------------------------------ #
    # the control loop
    # ------------------------------------------------------------------ #

    def tick(self) -> int:
        """One control-loop evaluation; returns the (possibly new) rung.
        Deterministic and side-effect-bounded: at most one rung transition
        per tick, so descent and recovery are both rung-by-rung."""
        with self._lock:
            pressure = self.pressure()
            self.last_pressure = pressure
            self.ticks += 1
            _PRESSURE_GAUGE.set(round(pressure, 6))
            if pressure >= self.config.high_water:
                self._high_ticks += 1
                self._low_ticks = 0
                if (
                    self._high_ticks >= self.config.engage_ticks
                    and self.rung < len(RUNG_REASONS)
                ):
                    self._engage(self.rung + 1, pressure)
                    self._high_ticks = 0
            elif pressure <= self.config.low_water:
                self._low_ticks += 1
                self._high_ticks = 0
                if self._low_ticks >= self.config.recover_ticks and self.rung > 0:
                    self._recover(pressure)
                    self._low_ticks = 0
            else:
                # the hysteresis dead band: hold the rung, reset both
                # debounce counters — neither threshold is being argued
                self._high_ticks = 0
                self._low_ticks = 0
            # late arrivals (fleet lazy loads) converge to the held rung
            if self.rung >= 1:
                self._apply_widen()
            if self.rung >= 2:
                self._apply_shed()
            if self.rung >= 3:
                self._apply_quality()
            return self.rung

    # ------------------------------------------------------------------ #
    # descent
    # ------------------------------------------------------------------ #

    def _engage(self, rung: int, pressure: float) -> None:
        reason = RUNG_REASONS[rung - 1]
        try:
            if rung == 1:
                degrade(
                    "autopilot_widen_batch",
                    "per-request latency-optimal coalescing",
                    "throughput-optimal linger/batch (reversible)",
                    detail=(
                        f"queue pressure {pressure:.3f} >= "
                        f"{self.config.high_water:g} for "
                        f"{self.config.engage_ticks} tick(s); widening "
                        f"batch x{self.config.widen_batch_factor:g}, "
                        f"linger x{self.config.widen_linger_factor:g}"
                    ),
                    strict=self.config.strict,
                )
            elif rung == 2:
                degrade(
                    "autopilot_shed_low_weight",
                    "all weight classes admitted",
                    "tenants below the top weight class refused (429)",
                    detail=(
                        f"queue pressure {pressure:.3f} persists at the "
                        "widened batch policy; shedding lowest-weight "
                        "tenants first"
                    ),
                    strict=self.config.strict,
                )
            else:
                services = self._services()
                q16 = self.config.force_q16 and not any(_on_card(s) for s in services)
                card_note = (
                    "; q16 left out on the card, where the port's q16 walk "
                    "is slower than the kernels it would replace"
                    if self.config.force_q16 and not q16
                    else ""
                )
                degrade(
                    "autopilot_quality_degrade",
                    "full-fidelity scoring",
                    (
                        f"subsample_trees={self.config.subsample_trees:g}"
                        + (", q16" if q16 else "")
                    ),
                    detail=(
                        f"queue pressure {pressure:.3f} persists after "
                        "shedding; degrading quality knobs (reported on "
                        "every response)" + card_note
                    ),
                    strict=self.config.strict,
                )
        except DegradationError as exc:
            # strict opt-out: the rung is REFUSED, visibly — the operator
            # pinned fidelity, so the autopilot reports and holds
            record_event(
                "autopilot.refused",
                rung=rung,
                reason=reason,
                pressure=round(pressure, 4),
            )
            if not self._refused_logged:
                self._refused_logged = True
                logger.warning(
                    "autopilot: strict=True refuses brownout rung %d (%s): %s",
                    rung,
                    reason,
                    exc,
                )
            return
        self.rung = rung
        _RUNG_GAUGE.set(rung)
        record_event(
            "autopilot.engage",
            rung=rung,
            reason=reason,
            pressure=round(pressure, 4),
        )
        logger.warning(
            "autopilot: engaging brownout rung %d (%s) at queue pressure %.3f",
            rung,
            reason,
            pressure,
        )

    def _widen_policy(self, coalescer) -> dict:
        cap = int(coalescer.max_queue_rows)
        return {
            "max_batch_rows": min(
                max(
                    int(coalescer.max_batch_rows * self.config.widen_batch_factor),
                    coalescer.max_batch_rows,
                ),
                cap,
            ),
            "max_linger_s": coalescer.max_linger_s
            * self.config.widen_linger_factor,
        }

    def _apply_widen(self) -> None:
        for service in self._services():
            key = id(service)
            if key in self._original_policy:
                continue
            coalescer = service.coalescer
            widened = self._widen_policy(coalescer)
            self._original_policy[key] = coalescer.reconfigure(**widened)
            # pin the service object so id() stays unique while tracked
            self._widened[key] = service

    def _revert_widen(self) -> None:
        for service in self._services():
            original = self._original_policy.pop(id(service), None)
            if original is not None:
                service.coalescer.reconfigure(**original)
        self._original_policy.clear()
        self._widened.clear()

    def _shed_retry_after_s(self) -> float:
        # the soonest the rung can lift: a full recovery debounce window
        return max(
            self.config.recover_ticks * self.config.tick_interval_s, 1.0
        )

    def _apply_shed(self) -> None:
        services = self._services()
        if not services:
            return
        top = max(s.config.weight for s in services)
        retry_after = self._shed_retry_after_s()
        for service in services:
            # the highest weight class attached is never shed
            shed = service.config.weight < top
            if shed != service.shed:
                service.set_shed(shed, retry_after_s=retry_after)

    def _lift_shed(self) -> None:
        for service in self._services():
            if service.shed:
                service.set_shed(False)

    def _q16_for(self, service) -> bool:
        """Whether rung 3 moves ``service`` onto the q16 plane: as
        configured on the CPU, never on the card (module doc)."""
        return self.config.force_q16 and not _on_card(service)

    def _apply_quality(self) -> None:
        for service in self._services():
            if service.quality is None:
                service.set_quality(
                    subsample_trees=self.config.subsample_trees,
                    force_q16=self._q16_for(service),
                )

    def _lift_quality(self) -> None:
        for service in self._services():
            if service.quality is not None:
                service.set_quality()

    # ------------------------------------------------------------------ #
    # recovery
    # ------------------------------------------------------------------ #

    def _recover(self, pressure: float) -> None:
        """Lift exactly ONE rung (the deepest engaged) — recovery is as
        stepwise as descent, so a pressure drop unwinds the ladder
        gradually and each lifted knob gets its own debounce window to
        prove the headroom is real."""
        rung = self.rung
        if rung >= 3:
            self._lift_quality()
        elif rung == 2:
            self._lift_shed()
        elif rung == 1:
            self._revert_widen()
        self.rung = rung - 1
        _RUNG_GAUGE.set(self.rung)
        record_event(
            "autopilot.recover",
            rung=rung,
            to_rung=self.rung,
            pressure=round(pressure, 4),
        )
        logger.info(
            "autopilot: pressure %.3f <= %g for %d tick(s); lifted rung %d -> %d",
            pressure,
            self.config.low_water,
            self.config.recover_ticks,
            rung,
            self.rung,
        )

    # ------------------------------------------------------------------ #
    # lifecycle / visibility
    # ------------------------------------------------------------------ #

    def state(self) -> dict:
        """Operator-facing controller state (plain JSON types) — the
        ``/healthz`` autopilot section and the debug-bundle section."""
        with self._lock:
            shed = sorted(
                str(s.model_id or "default")
                for s in self._services()
                if s.shed
            )
            return {
                "rung": self.rung,
                "rung_reason": (
                    RUNG_REASONS[self.rung - 1] if self.rung > 0 else None
                ),
                "pressure": round(self.last_pressure, 6),
                "ticks": self.ticks,
                "high_ticks": self._high_ticks,
                "low_ticks": self._low_ticks,
                "shed_tenants": shed,
                "strict": self.config.strict,
                "high_water": self.config.high_water,
                "low_water": self.config.low_water,
                "engage_ticks": self.config.engage_ticks,
                "recover_ticks": self.config.recover_ticks,
                "tick_interval_s": self.config.tick_interval_s,
            }

    def start(self) -> None:
        """Run :meth:`tick` from a daemon thread every ``tick_interval_s``
        (real deployments; tests tick directly). Idempotent."""
        with self._lock:
            if self._thread is not None:
                return
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="isoforest-autopilot"
            )
            self._thread.start()
        record_event(
            "autopilot.start",
            tick_interval_s=self.config.tick_interval_s,
            high_water=self.config.high_water,
            low_water=self.config.low_water,
            strict=self.config.strict,
        )

    def _run(self) -> None:
        while not self._stop.wait(self.config.tick_interval_s):
            try:
                self.tick()
            except Exception:  # a sensor hiccup must not kill the loop
                logger.exception("autopilot: tick failed; continuing")

    def close(self) -> None:
        """Stop the control thread and detach from the process-wide slot.
        Engaged rungs are left as-is — teardown belongs to the serving
        stack, and reverting knobs on dying services helps nobody."""
        with self._lock:
            thread = self._thread
            self._thread = None
            self._stop.set()
        if thread is not None:
            thread.join(timeout=10.0)
            record_event("autopilot.stop", rung=self.rung)
        global _ACTIVE
        with _ACTIVE_LOCK:
            if _ACTIVE is self:
                _ACTIVE = None


def mount_autopilot(server, autopilot: Autopilot) -> None:
    """Surface the controller on a running
    :class:`~isoforest_tpu_torch.telemetry.http.MetricsServer`: merge an
    ``autopilot`` section into the ``/healthz`` serving payload and
    register a debug-bundle section."""
    from ..telemetry import resources

    base = server.serving_state

    def merged() -> dict:
        doc = dict(base()) if base is not None else {}
        doc["autopilot"] = autopilot.state()
        return doc

    server.serving_state = merged
    resources.register_bundle_section("autopilot", autopilot.state)
