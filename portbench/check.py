"""How ``correct`` is decided: every answer the traffic loop kept, at the timed
sizes, against the plain reference's scores of the same rows.

Three numbers, each against the limit the configuration file states
(``limits``; PERF.md gives the readings each limit was set from). A row's
gap is ``|program - reference|`` beyond the reference's tolerance for that
row (:mod:`.reference.score`: what float32 sums and float32 dots at a
near-tie may move); a non-finite score's gap is ``GAP_NONFINITE``.

* ``max_excess``: the widest gap beyond its row's tolerance;
* ``rows_off``: the share of compared scores beyond their tolerance;
* ``missing``: answers that were due and never came, or came with the
  wrong number of scores.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

GAP_NONFINITE = 1e30


def compare(answers, due: int, reference) -> Dict[str, float]:
    """The numbers of :mod:`check` for ``answers`` (``Answer`` tuples over
    the reference's row indices) of which ``due`` were expected;
    ``reference`` holds the float64 ``scores`` and ``tolerance`` of every
    row (a ``reference.score.Scored``)."""
    widest, off, compared, missing = 0.0, 0, 0, max(0, due - len(answers))
    for a in answers:
        got = a.scores if isinstance(a.scores, torch.Tensor) else torch.from_numpy(np.asarray(a.scores))
        want, tol = reference.scores[a.start:a.stop], reference.tolerance[a.start:a.stop]
        if got.dim() != 1 or got.shape[0] != want.shape[0]:
            missing += 1
            continue
        excess = (got.to(want.device, torch.float64) - want).abs() - tol
        excess = torch.where(torch.isfinite(excess), excess, torch.full_like(excess, GAP_NONFINITE))
        if excess.numel():
            widest = max(widest, float(excess.max().clamp(min=0.0)))
            off += int((excess > 0).sum())
            compared += excess.numel()
    return {"max_excess": widest, "rows_off": off / compared if compared else 1.0, "missing": float(missing)}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(numbers[name] <= limits[name] for name in limits)


def lines(numbers: Dict[str, float], limits: Dict[str, float]) -> List[str]:
    return [f"check {name} {numbers[name]!r} limit {limits[name]!r}" for name in limits]
