"""Build-duration events of the port, the counterpart of the
``jax.monitoring`` duration events the JAX package listens to.

The port has no XLA compile. What a live request can pay for instead is a
build: an ``nvcc`` build of a kernel source (``ops/_build.py``) or the first
build of a model's kernel tables (``ops/traversal.py::scoring_tables``).
Each reports its wall seconds here, once, in the thread that paid for it;
:mod:`..telemetry.resources` registers the listener that turns them into
compile accounting. With no listener registered a report costs one loop
over an empty list.
"""

from __future__ import annotations

import threading
from typing import Callable, List

# an nvcc build of one kernel source; the listener gets ``key="nvcc:<name>"``
NVCC_BUILD_EVENT = "/isoforest_tpu_torch/build/nvcc_duration"
# the first build of one strategy's kernel tables for a forest on a device;
# ``key="tables:<strategy>"``
TABLE_BUILD_EVENT = "/isoforest_tpu_torch/build/tables_duration"

_LISTENERS: List[Callable[..., None]] = []
_LOCK = threading.Lock()


def register_event_duration_secs_listener(listener: Callable[..., None]) -> None:
    """Call ``listener(event, seconds, **fields)`` on every reported build."""
    with _LOCK:
        if listener not in _LISTENERS:
            _LISTENERS.append(listener)


def record_event_duration_secs(event: str, seconds: float, **fields) -> None:
    """Report one build of ``seconds`` to every registered listener, in the
    calling thread."""
    for listener in tuple(_LISTENERS):
        listener(event, seconds, **fields)
