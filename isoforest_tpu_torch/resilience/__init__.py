"""Resilience of the port (``isoforest_tpu/resilience``): model-directory
integrity (:mod:`.manifest`), fit checkpoints (:mod:`.checkpoint`), fault
injection at the seams (:mod:`.faults`), the scoring watchdog
(:mod:`.watchdog`) and the degradation ladder (:mod:`.degradation`, only the
rungs that hide no device and no kernel). The JAX package's retry layer and
peer heartbeats are not ported."""

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
from .watchdog import WatchdogTimeout

__all__ = [
    "checkpoint", "faults", "manifest", "watchdog", "LADDER", "CheckpointMismatchError", "DegradationError",
    "DegradationEvent", "DegradationReport", "FitCheckpoint", "LoadReport", "WatchdogTimeout",
    "degradation_report", "degradations", "degrade", "reset_degradations",
]
