"""The model lifecycle of the port (``isoforest_tpu/lifecycle``): drift-
triggered refits with validation-gated hot swaps.

A :class:`ModelManager` owns the active model, its score monitor and a
recent-data reservoir (:mod:`.window`). On sustained (debounced) drift it
refits on the window through the checkpointed fit on the model's device,
validates the candidate against the incumbent (:mod:`.validation`), saves
it sealed and swaps it in under a lock, with an event for every step and a
rollback on any failed gate or mid-swap fault. The work directory and the
events are the JAX package's.
"""

from .manager import (
    OUTCOME_ERROR,
    OUTCOME_SWAPPED,
    OUTCOME_SWAP_FAILED,
    OUTCOME_VALIDATION_FAILED,
    ModelManager,
    retrain_seed,
    state_snapshot,
)
from .validation import GateResult, ValidationGates, ValidationResult, validate_candidate
from .window import DataReservoir, DecayReservoir

__all__ = [
    "DataReservoir",
    "DecayReservoir",
    "GateResult",
    "ModelManager",
    "OUTCOME_ERROR",
    "OUTCOME_SWAPPED",
    "OUTCOME_SWAP_FAILED",
    "OUTCOME_VALIDATION_FAILED",
    "ValidationGates",
    "ValidationResult",
    "retrain_seed",
    "state_snapshot",
    "validate_candidate",
]
