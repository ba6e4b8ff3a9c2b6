"""Resilience of the port (``isoforest_tpu/resilience``): model-directory
integrity (:mod:`.manifest`), fit checkpoints (:mod:`.checkpoint`), fault
injection at the seams (:mod:`.faults`), the scoring watchdog and the peer
heartbeats (:mod:`.watchdog`), the degradation ladder
(:mod:`.degradation`, only the rungs that hide no device and no kernel) and
retry with backoff (:mod:`.retry`)."""

from . import checkpoint, faults, manifest, retry, watchdog
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
from .retry import DistributedTimeoutError, RetryError, RetryPolicy, backoff_schedule, retry_call
from .watchdog import HeartbeatWriter, WatchdogTimeout, format_heartbeat_ages, peer_heartbeat_ages

__all__ = [
    "checkpoint", "faults", "manifest", "retry", "watchdog", "LADDER", "CheckpointMismatchError",
    "DegradationError", "DegradationEvent", "DegradationReport", "DistributedTimeoutError", "FitCheckpoint",
    "HeartbeatWriter", "LoadReport", "RetryError", "RetryPolicy", "WatchdogTimeout", "backoff_schedule",
    "degradation_report", "degradations", "degrade", "format_heartbeat_ages", "peer_heartbeat_ages",
    "reset_degradations", "retry_call",
]
