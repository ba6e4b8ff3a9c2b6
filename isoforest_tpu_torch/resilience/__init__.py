"""Resilience of the port (``isoforest_tpu/resilience``): model-directory
integrity (:mod:`.manifest`), fit checkpoints (:mod:`.checkpoint`), fault
injection at the seams (:mod:`.faults`), the scoring watchdog and the peer
heartbeats (:mod:`.watchdog`) and the degradation ladder
(:mod:`.degradation`, only the rungs that hide no device and no kernel).
The JAX package's retry layer is not ported."""

from . import checkpoint, faults, manifest, watchdog
from .checkpoint import CheckpointMismatchError, FitCheckpoint
from .degradation import (
    LADDER,
    DegradationError,
    DegradationEvent,
    DegradationReport,
    LoadReport,
    degradation_report,
    degradations,
    degrade,
    reset_degradations,
)
from .watchdog import HeartbeatWriter, WatchdogTimeout, format_heartbeat_ages, peer_heartbeat_ages

__all__ = [
    "checkpoint", "faults", "manifest", "watchdog", "LADDER", "CheckpointMismatchError", "DegradationError",
    "DegradationEvent", "DegradationReport", "FitCheckpoint", "HeartbeatWriter", "LoadReport", "WatchdogTimeout",
    "degradation_report", "degradations", "degrade", "format_heartbeat_ages", "peer_heartbeat_ages",
    "reset_degradations",
]
