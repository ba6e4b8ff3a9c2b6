"""The traffic loops, one module a loop: a mix file (``traffic/<mix>.json``)
names its loop (``"loop": "bulk"``) and gives its parameters, and
:func:`load` finds ``loops/<loop>.py`` by that name. A loop module defines
``Loop(model, config, mix, seed, device)`` with ``rows`` (what the
reference scores), ``warm()``, ``window(seconds) -> Window`` and
``close()``. Nothing here knows a cell.

A loop keeps, for the comparison after the window, the answers it was
given (all of them, or a sample drawn from the seed) with the span of
reference rows each one answers. An answer that was due and never came,
because its call raised or was refused, counts in ``due`` and not in
``answers``: the comparison counts it missing.
"""

from __future__ import annotations

import importlib
import math
from typing import Dict, List, NamedTuple, Tuple

import torch


class Answer(NamedTuple):
    start: int  # the reference rows it answers, [start, stop)
    stop: int
    scores: object  # a tensor (device or host) or a numpy array


class Window(NamedTuple):
    attempted: int
    failed: int
    metrics: Dict[str, float]
    answers: List[Answer]  # what the comparison reads
    due: int  # answers the comparison expects
    served: Dict[Tuple[int, int], int]  # (start, stop) -> answers completed in the window
    w0_ns: int  # the window on the host's epoch clock
    w1_ns: int
    info: dict


def load(name: str):
    """The loop class of ``loops/<name>.py``."""
    return importlib.import_module(f"{__name__}.{name}").Loop


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def percentile(values: List[float], q: float) -> float:
    """Nearest-rank percentile ``q`` (0-100) of ``values``."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q / 100.0 * len(ordered)) - 1)]
