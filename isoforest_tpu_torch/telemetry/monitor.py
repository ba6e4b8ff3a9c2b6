"""The drift baseline and monitor (``isoforest_tpu/telemetry/monitor.py``).

* :func:`capture_baseline`: at fit, the training scores' histogram and
  exact quantiles and each feature's min/max/mean/histogram, from a strided
  subsample of the training rows. The :class:`Baseline` is saved beside
  the node table as ``_BASELINE.json``, sealed by the same
  ``_MANIFEST.json``, in the JAX package's format, so each package reads
  the other's.
* :class:`ScoreMonitor`: at serving, folds every batch into the
  baseline's histogram shape and computes the population stability index
  (PSI) and the Kolmogorov-Smirnov statistic (KS) of the scores and each
  input feature against the baseline, sets the ``isoforest_*_drift_*``
  gauges, and on a crossing records one ``drift.alert`` event and takes the
  ``drift_alert`` rung. Scores are never changed.

:meth:`ScoreMonitor.observe` folds on the batch's device (the card for a
served batch) and copies only the counts to the host (``64 + F x 32``
integers); PSI, KS and the alerts are evaluated there in float64, as the
JAX package does.

Bins. A value becomes a bin index as the JAX package computes it,
``int((v - lo) * scale)`` clipped into ``[0, bins - 1]``, with the float
to integer conversion of numpy on x86, where the JAX package's tests run:
NaN, +-inf and anything at or past 2^63 become the most negative integer
and so land in bin 0 (not in the last bin, as the reference's docstring
says a value past the training maximum should). The port computes that on
every device with an explicit mask (CUDA's own conversion would saturate
+inf into the last bin). The capture folds in float64, ``observe`` in
float32 with float32 ``lo`` and ``scale`` (in float64 for a float64
batch), as the JAX package does, so one value can land in neighbouring
bins in the two.
"""

from __future__ import annotations

import dataclasses
import json
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .events import record_event
from .metrics import counter as _counter
from .metrics import gauge as _gauge

BASELINE_NAME = "_BASELINE.json"
BASELINE_VERSION = 1

# scores live in [0, 1]; features span their training range
SCORE_BINS = 64
FEATURE_BINS = 32

# PSI bands: < 0.1 stable, 0.1-0.25 moderate shift, > 0.25 major shift;
# the default alert threshold is the major band
DEFAULT_PSI_THRESHOLD = 0.25

_SCORE_QUANTILES = (0.01, 0.05, 0.25, 0.50, 0.75, 0.95, 0.99)

# a float at or past 2^63 has no int64; numpy on x86 makes it INT64_MIN
_INT64_SPAN = 2.0**63

_SCORE_DRIFT_PSI = _gauge(
    "isoforest_score_drift_psi", "PSI of the serving score distribution vs the training baseline"
)
_SCORE_DRIFT_KS = _gauge(
    "isoforest_score_drift_ks", "KS statistic of the serving score distribution vs the training baseline"
)
_FEATURE_DRIFT_PSI = _gauge(
    "isoforest_feature_drift_psi", "PSI of each serving input feature vs the training baseline",
    labelnames=("feature",),
)
_MONITORED_ROWS_TOTAL = _counter("isoforest_monitored_rows_total", "Rows folded into the serving drift monitor")
# a monitor built with model_id= also exports its score PSI under that label
_FLEET_DRIFT_PSI = _gauge(
    "isoforest_fleet_drift_psi",
    "Per-tenant PSI of the serving score distribution vs the tenant model's training baseline",
    labelnames=("model_id",),
)


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _fold(values, lo: float, hi: float, bins: int) -> np.ndarray:
    """Histogram ``values`` into ``bins`` uniform buckets over ``[lo, hi]``
    in float64, on the host; out-of-range values clip into the edge
    buckets and non-finite ones land in bin 0 (the module's Bins)."""
    v = np.asarray(_host(values), np.float64).reshape(-1)
    if hi <= lo:  # a constant training feature
        hi = lo + 1.0
    with np.errstate(invalid="ignore", over="ignore"):
        t = (v - lo) * (bins / (hi - lo))
        bad = ~np.isfinite(t) | (t >= _INT64_SPAN)
    idx = np.where(bad, 0.0, np.clip(t, 0, bins - 1)).astype(np.int64)
    return np.bincount(idx, minlength=bins)


def _bin_index(t: torch.Tensor, bins: int) -> torch.Tensor:
    """:func:`_fold`'s bin of each scaled value, on ``t``'s device: NaN,
    +inf and values at or past 2^63 fail ``t < 2^63`` and go to 0, as -inf
    and the other negatives do by the clamp."""
    return torch.where(t < _INT64_SPAN, t, 0.0).clamp_(0, bins - 1).to(torch.int64)


def _count(idx: torch.Tensor, size: int) -> np.ndarray:
    """Histogram of bin indices on their device, copied to the host once.
    A scatter-add into a fixed size, where ``torch.bincount`` on a card
    would first read the largest index back."""
    counts = torch.zeros(size, dtype=torch.int64, device=idx.device)
    return counts.scatter_add_(0, idx, torch.ones_like(idx)).cpu().numpy()


def _check_histograms(p: np.ndarray, q: np.ndarray, name: str) -> None:
    if p.shape != q.shape or p.ndim != 1:
        raise ValueError(f"histograms must be 1-D and aligned; got {p.shape} vs {q.shape}")
    if p.sum() <= 0 or q.sum() <= 0:
        raise ValueError(f"{name} needs non-empty histograms on both sides")


def psi(expected_counts: Sequence[float], observed_counts: Sequence[float], eps: float = 1e-4) -> float:
    """Population stability index of two aligned histograms,
    ``sum((q_i - p_i) * ln(q_i / p_i))`` over the proportions ``p``
    (baseline) and ``q`` (serving), each floored at ``eps``."""
    p = np.asarray(expected_counts, np.float64)
    q = np.asarray(observed_counts, np.float64)
    _check_histograms(p, q, "psi")
    p = np.maximum(p / p.sum(), eps)
    q = np.maximum(q / q.sum(), eps)
    return float(np.sum((q - p) * np.log(q / p)))


def ks(expected_counts: Sequence[float], observed_counts: Sequence[float]) -> float:
    """Kolmogorov-Smirnov statistic of two aligned histograms: the largest
    difference of their empirical CDFs at the shared bucket edges."""
    p = np.asarray(expected_counts, np.float64)
    q = np.asarray(observed_counts, np.float64)
    _check_histograms(p, q, "ks")
    return float(np.max(np.abs(np.cumsum(p / p.sum()) - np.cumsum(q / q.sum()))))


@dataclasses.dataclass(frozen=True)
class StreamBaseline:
    """One monitored stream (the score, or one feature): a uniform
    histogram over ``[lo, hi]`` and the exact min/max/mean of the captured
    training values."""

    lo: float
    hi: float
    counts: Tuple[int, ...]
    min: float
    max: float
    mean: float

    def as_dict(self) -> dict:
        return {"lo": self.lo, "hi": self.hi, "counts": list(self.counts), "min": self.min, "max": self.max,
                "mean": self.mean}

    @classmethod
    def from_dict(cls, d: dict) -> "StreamBaseline":
        return cls(lo=float(d["lo"]), hi=float(d["hi"]), counts=tuple(int(c) for c in d["counts"]),
                   min=float(d["min"]), max=float(d["max"]), mean=float(d["mean"]))

    def fold(self, values) -> np.ndarray:
        return _fold(values, self.lo, self.hi, len(self.counts))


@dataclasses.dataclass(frozen=True)
class Baseline:
    """The training snapshot a :class:`ScoreMonitor` compares serving
    traffic with. Its JSON form is exact for the counts and
    ``repr``-faithful for the floats."""

    score: StreamBaseline
    features: Tuple[StreamBaseline, ...]
    score_quantiles: Dict[str, float]
    rows: int  # training rows the capture subsampled from
    captured_rows: int  # rows scored and histogrammed

    @property
    def num_features(self) -> int:
        return len(self.features)

    def as_dict(self) -> dict:
        return {
            "baselineVersion": BASELINE_VERSION,
            "rows": self.rows,
            "capturedRows": self.captured_rows,
            "score": self.score.as_dict(),
            "scoreQuantiles": dict(self.score_quantiles),
            "features": [f.as_dict() for f in self.features],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Baseline":
        version = d.get("baselineVersion")
        if version != BASELINE_VERSION:
            raise ValueError(
                f"baseline sidecar version {version!r} != supported "
                f"{BASELINE_VERSION} (written by an incompatible version)"
            )
        return cls(
            score=StreamBaseline.from_dict(d["score"]),
            features=tuple(StreamBaseline.from_dict(f) for f in d["features"]),
            score_quantiles={k: float(v) for k, v in d["scoreQuantiles"].items()},
            rows=int(d["rows"]),
            captured_rows=int(d["capturedRows"]),
        )

    def save(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.as_dict(), fh, indent=1, sort_keys=True)
            fh.write("\n")

    @classmethod
    def load(cls, path: str) -> "Baseline":
        with open(path) as fh:
            return cls.from_dict(json.load(fh))


def _stream_baseline(values: np.ndarray, lo: float, hi: float, bins: int) -> StreamBaseline:
    v = np.asarray(values, np.float64).reshape(-1)
    finite = v[np.isfinite(v)]
    if finite.size == 0:
        finite = np.zeros((1,), np.float64)
    return StreamBaseline(lo=float(lo), hi=float(hi), counts=tuple(int(c) for c in _fold(v, lo, hi, bins)),
                          min=float(finite.min()), max=float(finite.max()), mean=float(finite.mean()))


def capture_baseline(scores, X, total_rows: Optional[int] = None, score_bins: int = SCORE_BINS,
                     feature_bins: int = FEATURE_BINS) -> Baseline:
    """A :class:`Baseline` from row-aligned training scores and feature
    rows (tensors on any device, or arrays), computed in float64 with numpy
    on the host after one copy of each: the score range is ``[0, 1]``, each
    feature's its finite training min and max."""
    scores = np.asarray(_host(scores), np.float64).reshape(-1)
    X = np.asarray(_host(X), np.float64)
    if X.ndim != 2 or X.shape[0] != scores.shape[0]:
        raise ValueError(f"scores and X must be row-aligned; got {scores.shape} vs {X.shape}")
    if scores.size == 0:
        raise ValueError("cannot capture a baseline from zero rows")
    qs = np.quantile(scores, _SCORE_QUANTILES)
    features = []
    for i in range(X.shape[1]):
        col = X[:, i]
        finite = col[np.isfinite(col)]
        lo = float(finite.min()) if finite.size else 0.0
        hi = float(finite.max()) if finite.size else 1.0
        features.append(_stream_baseline(col, lo, hi, feature_bins))
    return Baseline(
        score=_stream_baseline(scores, 0.0, 1.0, score_bins),
        features=tuple(features),
        score_quantiles={f"p{int(q * 100):02d}": float(v) for q, v in zip(_SCORE_QUANTILES, qs)},
        rows=int(total_rows if total_rows is not None else scores.shape[0]),
        captured_rows=int(scores.shape[0]),
    )


def _as_float_tensor(a) -> torch.Tensor:
    """A float32 or float64 tensor of ``a`` where it lies (an array goes to
    the CPU without a copy); other types become float32, as in the JAX
    package."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
    return t if t.dtype in (torch.float32, torch.float64) else t.to(torch.float32)


class ScoreMonitor:
    """Streaming drift monitor: folds served batches, compares them with a baseline.

    ``model.enable_monitoring()`` attaches one, and every ``model.score``
    then folds its batch; or call :meth:`observe`. Thread-safe.
    ``threshold``/``feature_threshold``: PSI alert levels. Alerts are
    edge-triggered per stream: a crossing records one ``drift.alert`` event
    (and with ``ladder=True`` takes the ``drift_alert`` rung) and re-arms
    only after the stream's PSI falls back under its threshold.
    ``min_rows`` holds evaluation back until the fold means something. A
    batch folds at most ``max_score_rows_per_batch`` /
    ``max_feature_rows_per_batch`` strided rows (``rows`` still counts every
    served row).
    """

    def __init__(
        self,
        baseline: Baseline,
        threshold: float = DEFAULT_PSI_THRESHOLD,
        feature_threshold: Optional[float] = None,
        ladder: bool = True,
        min_rows: int = 512,
        max_score_rows_per_batch: int = 32768,
        max_feature_rows_per_batch: int = 2048,
        model_id: Optional[str] = None,
    ) -> None:
        if threshold <= 0:
            raise ValueError(f"threshold must be positive, got {threshold}")
        self.model_id = None if model_id is None else str(model_id)
        self.threshold = float(threshold)
        self.feature_threshold = float(feature_threshold if feature_threshold is not None else threshold)
        self.ladder = bool(ladder)
        self.min_rows = int(min_rows)
        self.max_score_rows_per_batch = int(max_score_rows_per_batch)
        self.max_feature_rows_per_batch = int(max_feature_rows_per_batch)
        self._lock = threading.Lock()
        self._bind(baseline)

    def _bind(self, baseline: Baseline) -> None:
        """Target ``baseline``: fresh counts, every alert re-armed. Callers
        other than ``__init__`` hold ``self._lock``."""
        self.baseline = baseline
        self._score_counts = np.zeros(len(baseline.score.counts), np.int64)
        self._rows = 0
        self._feature_rows = 0
        self._rows_at_eval = 0
        self._feature_rows_at_eval = 0
        self._alerted: set = set()
        self._alerts: List[dict] = []
        s = baseline.score
        self._score_bins = len(s.counts)
        self._score_lo = float(np.float32(s.lo))
        self._score_scale = float(np.float32(self._score_bins / ((s.hi - s.lo) if s.hi > s.lo else 1.0)))
        # every capture_baseline feature has one bin count: all streams fold
        # in one bincount over offset indices; a hand-built baseline with
        # mixed counts folds stream by stream on the host
        bins_per_feature = {len(f.counts) for f in baseline.features}
        self._uniform = len(bins_per_feature) <= 1
        self._f_bins = bins_per_feature.pop() if self._uniform and bins_per_feature else 0
        self._f_consts: dict = {}  # (device, dtype) -> (lo, scale, offsets past the score bins)
        if self._uniform:
            self._feature_counts = np.zeros((baseline.num_features, self._f_bins), np.int64)
            self._f_lo = np.asarray([f.lo for f in baseline.features], np.float32)
            self._f_scale = np.asarray(
                [self._f_bins / ((f.hi - f.lo) if f.hi > f.lo else 1.0) for f in baseline.features], np.float32
            )
        else:
            self._feature_counts = [np.zeros(len(f.counts), np.int64) for f in baseline.features]
        if self._uniform and baseline.num_features:
            # baseline proportions floored at psi()'s eps, for one pass over [F, bins]
            p = np.asarray([f.counts for f in baseline.features], np.float64)
            self._f_p = np.maximum(p / np.maximum(p.sum(axis=1, keepdims=True), 1.0), 1e-4)
        else:
            self._f_p = None

    @property
    def rows(self) -> int:
        with self._lock:
            return self._rows

    def _feature_consts(self, device, dtype):
        key = (device, dtype)
        consts = self._f_consts.get(key)
        if consts is None:
            consts = self._f_consts[key] = (
                torch.from_numpy(self._f_lo).to(device, dtype),
                torch.from_numpy(self._f_scale).to(device, dtype),
                torch.arange(self.baseline.num_features, device=device, dtype=torch.int64) * self._f_bins
                + self._score_bins,
            )
        return consts

    def observe(self, scores, X=None) -> None:
        """Fold one served batch: its scores and, when given, its feature
        rows (tensors on any device, or arrays). ``model.score`` calls this
        when monitoring is on."""
        scores = _as_float_tensor(scores)
        if scores.numel() == 0:
            return
        base = self.baseline
        total_rows = int(scores.numel())
        v = scores.reshape(-1)
        step = max(1, -(-v.shape[0] // self.max_score_rows_per_batch))
        if step > 1:
            v = v[::step]
        # one index vector per device: the score bins, then each feature's
        parts = [_bin_index((v - self._score_lo) * self._score_scale, self._score_bins)]
        feature_fold = None
        sub_rows = 0
        if X is not None:
            X = _as_float_tensor(X)
            if X.dim() != 2 or X.shape[1] != base.num_features:
                raise ValueError(
                    f"monitored X must be [N, {base.num_features}] to match the baseline; "
                    f"got shape {tuple(X.shape)}"
                )
            step = max(1, -(-X.shape[0] // self.max_feature_rows_per_batch))
            # rows left on the host (model.score streams them) fold on the
            # scores' device: only the stride subsample is copied
            sub = X[::step].to(v.device)
            sub_rows = int(sub.shape[0])
            if self._uniform:
                lo, scale, offsets = self._feature_consts(sub.device, sub.dtype)
                parts.append((_bin_index((sub - lo) * scale, self._f_bins) + offsets).reshape(-1))
            else:
                host = _host(sub)
                feature_fold = [base.features[i].fold(host[:, i]) for i in range(base.num_features)]
        size = self._score_bins + (base.num_features * self._f_bins if self._uniform else 0)
        if len(parts) == 2 and parts[0].device == parts[1].device:
            counts = _count(torch.cat(parts), size)
        else:
            counts = sum(_count(p, size) for p in parts)
        score_fold = counts[: self._score_bins]
        if len(parts) == 2:
            feature_fold = counts[self._score_bins :].reshape(base.num_features, self._f_bins)
        with self._lock:
            self._score_counts += score_fold
            self._rows += total_rows
            if feature_fold is not None:
                if self._uniform:
                    self._feature_counts += feature_fold
                else:
                    for acc, fold in zip(self._feature_counts, feature_fold):
                        acc += fold
                self._feature_rows += sub_rows
        _MONITORED_ROWS_TOTAL.inc(total_rows)
        self._evaluate()

    def drift(self) -> dict:
        """Current statistics: ``{"rows", "feature_rows", "score": {psi,
        ks}, "features": {index: psi}}``; a stream with too few folded
        rows is absent."""
        base = self.baseline
        with self._lock:
            rows = self._rows
            feature_rows = self._feature_rows
            score_counts = self._score_counts.copy()
            if self._uniform:
                feature_counts = self._feature_counts.copy()
            else:
                feature_counts = [c.copy() for c in self._feature_counts]
        out: dict = {"rows": rows, "feature_rows": feature_rows}
        if rows >= self.min_rows:
            out["score"] = {"psi": psi(base.score.counts, score_counts), "ks": ks(base.score.counts, score_counts)}
        if feature_rows >= self.min_rows and base.num_features:
            if self._uniform:
                q = feature_counts.astype(np.float64)
                q = np.maximum(q / np.maximum(q.sum(axis=1, keepdims=True), 1.0), 1e-4)
                vals = ((q - self._f_p) * np.log(q / self._f_p)).sum(axis=1)
                out["features"] = {i: float(v) for i, v in enumerate(vals)}
            else:
                out["features"] = {i: psi(base.features[i].counts, feature_counts[i])
                                   for i in range(base.num_features)}
        return out

    def report(self) -> dict:
        """Summary for an operator: thresholds, drift per stream and every
        alert so far, in plain JSON types."""
        d = self.drift()
        with self._lock:
            alerts = [dict(a) for a in self._alerts]
        report = {
            "rows": d["rows"],
            "feature_rows": d["feature_rows"],
            "threshold": self.threshold,
            "feature_threshold": self.feature_threshold,
            "drifted": bool(alerts),
            "alerts": alerts,
        }
        if "score" in d:
            report["score"] = {"psi": round(d["score"]["psi"], 6), "ks": round(d["score"]["ks"], 6)}
        if "features" in d:
            report["features"] = {str(i): round(v, 6) for i, v in sorted(d["features"].items())}
        return report

    def reset(self) -> None:
        """Drop the folded counts and re-arm every alert; the baseline stays."""
        with self._lock:
            self._bind(self.baseline)

    def rebind(self, baseline: Baseline) -> None:
        """Target a new baseline (after the model behind the monitor is
        replaced): the counts are dropped and every alert re-arms."""
        if baseline.num_features != self.baseline.num_features:
            raise ValueError(
                f"rebind baseline has {baseline.num_features} features, monitor was built for "
                f"{self.baseline.num_features} — a swap may not change the serving feature width"
            )
        with self._lock:
            self._bind(baseline)

    def _evaluate(self) -> None:
        # evaluate again only after ~10% more rows: PSI over accumulated
        # counts moves slowly; drift() and report() compute afresh
        def _grew(now: int, then: int) -> bool:
            return now > 0 if then == 0 else now >= max(then + 1, int(then * 1.1))

        with self._lock:
            if self._rows < self.min_rows:
                return
            if not (_grew(self._rows, self._rows_at_eval) or _grew(self._feature_rows, self._feature_rows_at_eval)):
                return
            self._rows_at_eval = self._rows
            self._feature_rows_at_eval = self._feature_rows
        d = self.drift()
        if "score" in d:
            _SCORE_DRIFT_PSI.set(d["score"]["psi"])
            _SCORE_DRIFT_KS.set(d["score"]["ks"])
            if self.model_id is not None:
                _FLEET_DRIFT_PSI.set(d["score"]["psi"], model_id=self.model_id)
            self._check("score", d["score"]["psi"], self.threshold, d["rows"])
        if "features" in d:
            for i, value in d["features"].items():
                _FEATURE_DRIFT_PSI.set(value, feature=i)
                self._check(f"feature:{i}", value, self.feature_threshold, d["feature_rows"])

    def _check(self, stream: str, value: float, threshold: float, rows: int) -> None:
        with self._lock:
            if not value > threshold:
                self._alerted.discard(stream)  # re-arm once back in band
                return
            if stream in self._alerted:
                return
            self._alerted.add(stream)
            alert = {"stream": stream, "psi": round(float(value), 6), "threshold": threshold, "rows": rows}
            if self.model_id is not None:
                alert["model_id"] = self.model_id
            self._alerts.append(alert)
        record_event("drift.alert", **alert)
        if self.ladder:
            from ..resilience.degradation import degrade

            degrade(
                "drift_alert",
                "in-distribution serving traffic",
                "drifted serving traffic (scores still exact)",
                detail=(
                    f"drift monitor: {stream} PSI {value:.4f} crossed the alert threshold {threshold:g} "
                    f"after {rows} served rows — serving inputs no longer match the training baseline"
                ),
            )
