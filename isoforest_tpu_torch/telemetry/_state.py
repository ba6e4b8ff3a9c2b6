"""Process-wide telemetry on/off switch (``isoforest_tpu/telemetry/_state.py``).

One flag shared by the metrics and the event timeline: when it is off,
metric mutators return at once and ``record_event`` drops the event. It is
read from ``ISOFOREST_TPU_TELEMETRY`` at import (default on;
``0``/``false``/``off``/``no``/``disabled`` turn it off), the variable the
JAX package reads, and flips at run time with :func:`enable` and
:func:`disable`.
"""

from __future__ import annotations

import os

_OFF_VALUES = frozenset({"0", "false", "off", "no", "disabled"})

ENV_VAR = "ISOFOREST_TPU_TELEMETRY"


class _State:
    __slots__ = ("enabled",)

    def __init__(self) -> None:
        self.enabled = os.environ.get(ENV_VAR, "1").strip().lower() not in _OFF_VALUES


_STATE = _State()


def enabled() -> bool:
    """True when telemetry collection is on."""
    return _STATE.enabled


def enable() -> None:
    """Turn telemetry collection on (what was recorded is kept)."""
    _STATE.enabled = True


def disable() -> None:
    """Turn telemetry collection off; instrumented code becomes a no-op."""
    _STATE.enabled = False
