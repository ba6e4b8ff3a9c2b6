"""Logging and phase tracing (``isoforest_tpu/utils/logging.py``).

The reference logs at phase boundaries through Spark's ``Logging`` mixin
(SharedTrainLogic.scala:39-42, 118-126, 147-150). The port keeps the JAX
package's three layers: the ``isoforest_tpu_torch`` logger, whose level
``ISOFOREST_TPU_LOGLEVEL`` sets (default WARNING); :func:`phase`, a
telemetry span (a ``torch.profiler`` range too) that logs its time; and
:func:`trace`, a ``torch.profiler`` trace of a block written into a
directory, where the JAX package writes a ``jax.profiler`` trace.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

import torch

LOGLEVEL_ENV = "ISOFOREST_TPU_LOGLEVEL"

# marks the package's own stream handler, so a reload of this module finds
# it again instead of adding a second one (every record would print twice)
_HANDLER_MARK = "_isoforest_tpu_torch_handler"

logger = logging.getLogger("isoforest_tpu_torch")


def _configured_level() -> str:
    return os.environ.get(LOGLEVEL_ENV, "WARNING").upper()


if not any(getattr(h, _HANDLER_MARK, False) for h in logger.handlers):
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("%(asctime)s %(name)s %(levelname)s: %(message)s"))
    setattr(_h, _HANDLER_MARK, True)
    logger.addHandler(_h)
    logger.setLevel(_configured_level())


def set_level(level: int | str | None = None) -> str:
    """Set the package's log level; ``None`` reads ``ISOFOREST_TPU_LOGLEVEL``
    again from the current environment. Returns the level's name."""
    logger.setLevel(_configured_level() if level is None else level)
    return logging.getLevelName(logger.level)


@contextlib.contextmanager
def trace(log_dir: str):
    """Record a ``torch.profiler`` trace of the block (the host, and the
    card when there is one) and write it into ``log_dir`` as a Chrome trace
    ``<worker>.<time>.pt.trace.json``, which TensorBoard's PyTorch profiler
    view and ``chrome://tracing`` read::

        with isoforest_tpu_torch.utils.logging.trace("traces"):
            model = IsolationForest().fit(X)
    """
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
    logger.info("profiler trace written to %s", log_dir)


@contextlib.contextmanager
def phase(name: str, log_level: int = logging.INFO):
    """Time a named phase: a telemetry span while telemetry is on (the
    span is also a ``torch.profiler`` range), else a bare
    ``record_function`` range, so a trace shows the phase either way; then
    a log record of its time."""
    from ..telemetry import _state
    from ..telemetry.spans import span

    ctx = span(name, annotate=True) if _state.enabled() else torch.profiler.record_function(name)
    start = time.perf_counter()
    with ctx:
        yield
    logger.log(log_level, "phase %s took %.3fs", name, time.perf_counter() - start)
