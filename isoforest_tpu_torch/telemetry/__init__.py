"""Telemetry of the port (``isoforest_tpu/telemetry``): the process-wide
on/off switch, the event timeline and the metrics registry, the drift
baseline and monitor (:mod:`.monitor`) and forest diagnostics
(:mod:`.diagnostics`). Spans, export, HTTP, the journal, federation and
resource accounting are not ported."""

from ._state import disable, enable, enabled
from .events import Event, get_events, record_event, reset_events
from .metrics import counter, gauge, registry, reset_metrics


def reset() -> None:
    """Clear recorded events and every metric series (tests, operators)."""
    reset_events()
    reset_metrics()


__all__ = [
    "Event", "counter", "disable", "enable", "enabled", "gauge", "get_events",
    "record_event", "registry", "reset", "reset_events", "reset_metrics",
]
