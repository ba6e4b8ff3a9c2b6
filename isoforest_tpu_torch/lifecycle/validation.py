"""Candidate-validation gates: a refit is never swapped in on faith
(``isoforest_tpu/lifecycle/validation.py``).

The candidate is validated against the incumbent on a stride sample of the
window it trained on. Four gates, each a measured value against a bound:

* ``finite``: every candidate score on the reference slice is finite and in
  ``[0, 1]``;
* ``score_parity``: mean ``|candidate - incumbent|`` is at most
  ``max_score_delta``. Under real drift the two should disagree, so the
  default bound (0.4) is loose: it catches scores that are broken, not
  adapted;
* ``baseline_sanity``: the candidate carries a drift baseline whose
  quantiles are ordered and whose median lies in ``median_band``, and its
  own scores on the slice show PSI under ``max_candidate_psi`` against it
  (the predictor that drift falls back under its threshold after a swap);
* ``auroc``: only with labels: the candidate's AUROC trails the
  incumbent's by at most ``auroc_margin``.

Both models score the slice through their own ``score`` on their device
(the kernels on the card); each score vector is copied to the host once,
and the gates run in float64 there, as in the JAX package. The
``fail_validation`` fault seam adds a failing gate.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..resilience import faults
from ..telemetry.monitor import DEFAULT_PSI_THRESHOLD, psi


@dataclasses.dataclass(frozen=True)
class ValidationGates:
    """Gate bounds for :func:`validate_candidate`: the defaults pass a
    healthy refit on drifted traffic and fail a poisoned or degenerate one."""

    max_score_delta: float = 0.4
    max_candidate_psi: float = DEFAULT_PSI_THRESHOLD
    median_band: Tuple[float, float] = (0.05, 0.95)
    auroc_margin: float = 0.02
    max_reference_rows: int = 8192

    def __post_init__(self) -> None:
        if self.max_score_delta <= 0 or self.max_candidate_psi <= 0:
            raise ValueError("gate bounds must be positive")
        lo, hi = self.median_band
        if not 0.0 <= lo < hi <= 1.0:
            raise ValueError(f"median_band must be within [0, 1], got {self.median_band}")
        if self.max_reference_rows < 1:
            raise ValueError("max_reference_rows must be >= 1")


@dataclasses.dataclass(frozen=True)
class GateResult:
    """One gate's verdict: the measured value against its bound."""

    name: str
    passed: bool
    value: Optional[float]
    bound: Optional[float]
    detail: str = ""

    def as_dict(self) -> dict:
        return {"name": self.name, "passed": self.passed, "value": self.value, "bound": self.bound,
                "detail": self.detail}


@dataclasses.dataclass(frozen=True)
class ValidationResult:
    passed: bool
    gates: Tuple[GateResult, ...]
    reference_rows: int

    def failed_gates(self) -> Tuple[str, ...]:
        return tuple(g.name for g in self.gates if not g.passed)

    def as_dict(self) -> dict:
        return {"passed": self.passed, "reference_rows": self.reference_rows,
                "gates": [g.as_dict() for g in self.gates]}


def _auroc(scores: np.ndarray, labels: np.ndarray) -> float:
    order = np.argsort(scores, kind="stable")
    ranks = np.empty(len(scores))
    ranks[order] = np.arange(1, len(scores) + 1)
    pos = labels == 1
    n1, n0 = int(pos.sum()), int((~pos).sum())
    if n1 == 0 or n0 == 0:
        return float("nan")
    return float((ranks[pos].sum() - n1 * (n1 + 1) / 2) / (n1 * n0))


def _host_scores(model, ref: np.ndarray) -> np.ndarray:
    """``model.score`` of the slice (on the model's device) as host float64:
    one copy from the card."""
    scores = model.score(ref, nonfinite="allow")
    if isinstance(scores, torch.Tensor):
        scores = scores.detach().cpu().numpy()
    return np.asarray(scores, np.float64)


def validate_candidate(
    incumbent,
    candidate,
    X: np.ndarray,
    y: Optional[np.ndarray] = None,
    gates: Optional[ValidationGates] = None,
) -> ValidationResult:
    """Every gate for ``candidate`` against ``incumbent`` on a deterministic
    stride sample of ``X`` (at most ``max_reference_rows``). Returns the
    per-gate verdict; a failing gate never raises (the caller rolls back)."""
    gates = gates or ValidationGates()
    X = np.asarray(X, np.float32)
    if X.ndim != 2 or X.shape[0] == 0:
        raise ValueError(f"reference data must be non-empty [N, F]; got {X.shape}")
    step = max(1, -(-X.shape[0] // gates.max_reference_rows))
    ref = np.ascontiguousarray(X[::step])
    ref_y = None if y is None else np.asarray(y, np.float64).reshape(-1)[::step]

    results = []
    # nonfinite="allow": the serving path already applied the input policy
    cand = _host_scores(candidate, ref)
    inc = _host_scores(incumbent, ref)

    finite = bool(np.isfinite(cand).all() and (cand >= 0.0).all() and (cand <= 1.0).all())
    results.append(GateResult(name="finite", passed=finite, value=float(np.isfinite(cand).mean()), bound=1.0,
                              detail="all candidate scores finite and in [0, 1]"))

    delta = float(np.mean(np.abs(cand - inc))) if finite else float("inf")
    results.append(GateResult(
        name="score_parity",
        passed=delta <= gates.max_score_delta,
        value=round(delta, 6) if np.isfinite(delta) else delta,
        bound=gates.max_score_delta,
        detail="mean |candidate - incumbent| on the reference slice",
    ))

    baseline = getattr(candidate, "baseline", None)
    if baseline is None:
        results.append(GateResult(
            name="baseline_sanity", passed=False, value=None, bound=None,
            detail="candidate carries no drift baseline — the monitor could not rebind after a swap",
        ))
    else:
        q = baseline.score_quantiles
        lo, hi = gates.median_band
        ordered = q["p01"] <= q["p50"] <= q["p99"]
        in_band = lo <= q["p50"] <= hi
        self_psi = psi(baseline.score.counts, baseline.score.fold(cand)) if finite else float("inf")
        ok = bool(ordered and in_band and self_psi <= gates.max_candidate_psi)
        results.append(GateResult(
            name="baseline_sanity",
            passed=ok,
            value=round(self_psi, 6) if np.isfinite(self_psi) else self_psi,
            bound=gates.max_candidate_psi,
            detail=(f"median {q['p50']:.4f} in [{lo:g}, {hi:g}]={in_band}, quantiles ordered={ordered}, "
                    "reference-slice PSI vs own baseline"),
        ))

    if ref_y is not None and 0 < int((ref_y == 1).sum()) < ref_y.shape[0]:
        cand_auroc = _auroc(cand, ref_y)
        inc_auroc = _auroc(inc, ref_y)
        results.append(GateResult(
            name="auroc",
            passed=bool(cand_auroc >= inc_auroc - gates.auroc_margin),
            value=round(cand_auroc, 6),
            bound=round(inc_auroc - gates.auroc_margin, 6),
            detail=f"incumbent AUROC {inc_auroc:.4f}, margin {gates.auroc_margin:g}",
        ))

    try:
        faults.check_validation()
    except faults.FaultInjectedError as exc:
        results.append(GateResult(name="fault_injected", passed=False, value=None, bound=None, detail=str(exc)))

    return ValidationResult(passed=all(g.passed for g in results), gates=tuple(results),
                            reference_rows=int(ref.shape[0]))
