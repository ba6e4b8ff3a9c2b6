"""Process-wide metrics registry: counters, gauges and fixed-bucket
histograms (``isoforest_tpu/telemetry/metrics.py``, copied: it is stdlib only).

Prometheus-shaped: counters end in ``_total``, histograms keep cumulative
``le`` bucket semantics (a value lands in the first bucket whose upper bound
is ``>= value``), and every metric carries a fixed ``labelnames`` tuple with
one series per label set. Histograms also keep exact ``min``/``max`` per
series and derive p50/p95/p99 by linear interpolation inside the matched
bucket, clamped to the observed min/max. Thread-safe. With telemetry off
(:mod:`._state`) every mutator returns at once; readers always work.
"""

from __future__ import annotations

import bisect
import math
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from . import _state

# Default buckets for wall-clock durations: 100 us .. 60 s, roughly 2.5x
# steps, wide enough for a 1-row serving score and a 1M-row bulk pass.
DEFAULT_LATENCY_BUCKETS: Tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


def exponential_buckets(start: float, factor: float, count: int) -> Tuple[float, ...]:
    """``count`` geometric bucket bounds from ``start`` (the serving request
    histogram's ~1.3x steps resolve p99 to ~30%)."""
    if start <= 0 or factor <= 1 or count < 1:
        raise ValueError(f"need start > 0, factor > 1, count >= 1; got {start}, {factor}, {count}")
    return tuple(start * factor**i for i in range(count))


def _check_labels(labelnames: Tuple[str, ...], labels: Dict[str, object]) -> Tuple[str, ...]:
    if set(labels) != set(labelnames):
        raise ValueError(
            f"label mismatch: metric declares {list(labelnames)}, "
            f"call supplied {sorted(labels)}"
        )
    return tuple(str(labels[name]) for name in labelnames)


class _Metric:
    """Shared per-metric machinery: name/help/labelnames + series dict."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Sequence[str]) -> None:
        self.name = str(name)
        self.help = str(help)
        self.labelnames = tuple(str(n) for n in labelnames)
        self._lock = threading.Lock()
        self._series: Dict[Tuple[str, ...], object] = {}

    def _clear(self) -> None:
        with self._lock:
            self._series.clear()

    def series_labels(self) -> List[Dict[str, str]]:
        with self._lock:
            return [
                dict(zip(self.labelnames, key)) for key in sorted(self._series)
            ]


class Counter(_Metric):
    """Monotonically increasing count; ``inc(amount, **labels)``."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels: object) -> None:
        if not _state.enabled():
            return
        if amount < 0:
            raise ValueError(f"counters only go up; got inc({amount})")
        key = _check_labels(self.labelnames, labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def value(self, **labels: object) -> float:
        key = _check_labels(self.labelnames, labels)
        with self._lock:
            return float(self._series.get(key, 0.0))

    def snapshot(self) -> dict:
        with self._lock:
            series = [
                {"labels": dict(zip(self.labelnames, key)), "value": value}
                for key, value in sorted(self._series.items())
            ]
        return {
            "type": self.kind,
            "help": self.help,
            "labelnames": list(self.labelnames),
            "series": series,
        }


class Gauge(_Metric):
    """Point-in-time value; ``set``/``inc``/``dec``."""

    kind = "gauge"

    def set(self, value: float, **labels: object) -> None:
        if not _state.enabled():
            return
        key = _check_labels(self.labelnames, labels)
        with self._lock:
            self._series[key] = float(value)

    def inc(self, amount: float = 1.0, **labels: object) -> None:
        if not _state.enabled():
            return
        key = _check_labels(self.labelnames, labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels: object) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels: object) -> float:
        key = _check_labels(self.labelnames, labels)
        with self._lock:
            return float(self._series.get(key, 0.0))

    snapshot = Counter.snapshot


class _HistSeries:
    __slots__ = ("bucket_counts", "count", "sum", "min", "max")

    def __init__(self, num_buckets: int) -> None:
        self.bucket_counts = [0] * num_buckets
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None


class Histogram(_Metric):
    """Fixed-bucket histogram with Prometheus ``le`` semantics plus exact
    min/max per series. ``buckets`` are the finite upper bounds; a final
    ``+Inf`` bucket is implicit."""

    kind = "histogram"

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS) -> None:
        super().__init__(name, help, labelnames)
        bounds = tuple(float(b) for b in buckets)
        if not bounds:
            raise ValueError("histogram needs at least one finite bucket bound")
        if any(b2 <= b1 for b1, b2 in zip(bounds, bounds[1:])):
            raise ValueError(f"bucket bounds must strictly increase: {bounds}")
        if math.isinf(bounds[-1]):
            bounds = bounds[:-1]  # +Inf is implicit
        self.buckets = bounds

    def observe(self, value: float, **labels: object) -> None:
        if not _state.enabled():
            return
        value = float(value)
        key = _check_labels(self.labelnames, labels)
        # first index whose bound >= value is the `le` bucket; past the last
        # finite bound lands in the implicit +Inf slot
        index = bisect.bisect_left(self.buckets, value)
        with self._lock:
            series = self._series.get(key)
            if series is None:
                series = self._series[key] = _HistSeries(len(self.buckets) + 1)
            series.bucket_counts[index] += 1
            series.count += 1
            series.sum += value
            series.min = value if series.min is None else min(series.min, value)
            series.max = value if series.max is None else max(series.max, value)

    def _get(self, labels: Dict[str, object]) -> Optional[_HistSeries]:
        key = _check_labels(self.labelnames, labels)
        with self._lock:
            return self._series.get(key)

    def quantile(self, q: float, **labels: object) -> float:
        """Bucket-interpolated quantile in ``[0, 1]``; 0.0 when empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        series = self._get(labels)
        if series is None or series.count == 0:
            return 0.0
        target = q * series.count
        cumulative = 0.0
        lower = 0.0
        estimate = lower
        for bound, in_bucket in zip(self.buckets + (math.inf,), series.bucket_counts):
            previous = cumulative
            cumulative += in_bucket
            if cumulative >= target and in_bucket > 0:
                estimate = lower if math.isinf(bound) else lower + (bound - lower) * ((target - previous) / in_bucket)
                break
            if not math.isinf(bound):
                lower = bound
        # a wide bucket must not report a value outside anything observed
        return min(max(estimate, series.min), series.max)

    def summary(self, **labels: object) -> dict:
        """``{count, sum, min, max, p50, p95, p99}`` for one series."""
        series = self._get(labels)
        if series is None or series.count == 0:
            return {"count": 0, "sum": 0.0, "min": None, "max": None, "p50": None, "p95": None, "p99": None}
        return {
            "count": series.count, "sum": series.sum, "min": series.min, "max": series.max,
            "p50": self.quantile(0.50, **labels), "p95": self.quantile(0.95, **labels),
            "p99": self.quantile(0.99, **labels),
        }

    def snapshot(self) -> dict:
        bounds = [*self.buckets, math.inf]
        with self._lock:
            series = [
                {
                    "labels": dict(zip(self.labelnames, key)), "count": s.count, "sum": s.sum,
                    "min": s.min, "max": s.max,
                    # per-bucket (non-cumulative) counts; +Inf serialises as "+Inf"
                    "buckets": [["+Inf" if math.isinf(b) else b, c] for b, c in zip(bounds, s.bucket_counts)],
                }
                for key, s in sorted(self._series.items())
            ]
        return {"type": self.kind, "help": self.help, "labelnames": list(self.labelnames), "series": series}


class MetricsRegistry:
    """Get-or-create registry; one process-wide instance backs the module
    helpers. Re-registering a name with a different type, labelnames or
    buckets raises — a silent shape change would corrupt every existing series."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_create(self, cls, name: str, help: str, labelnames, **kw) -> _Metric:
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, cls) or existing.labelnames != tuple(
                    labelnames
                ):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{existing.kind} with labels {existing.labelnames}"
                    )
                buckets = kw.get("buckets")
                if isinstance(existing, Histogram) and buckets is not None and existing.buckets != buckets:
                    raise ValueError(f"histogram {name!r} already registered with buckets {existing.buckets}")
                return existing
            metric = cls(name, help, labelnames, **{k: v for k, v in kw.items() if v is not None})
            self._metrics[name] = metric
            return metric

    def counter(self, name: str, help: str = "", labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "", labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "", labelnames: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        if buckets is not None:
            buckets = tuple(float(b) for b in buckets)
            if buckets and math.isinf(buckets[-1]):
                buckets = buckets[:-1]  # +Inf is implicit, as in Histogram
        return self._get_or_create(Histogram, name, help, labelnames, buckets=buckets)

    def metrics(self) -> List[_Metric]:
        with self._lock:
            return [self._metrics[name] for name in sorted(self._metrics)]

    def snapshot(self) -> Dict[str, dict]:
        return {m.name: m.snapshot() for m in self.metrics()}

    def reset(self) -> None:
        """Clear every series IN PLACE — metric objects cached at module
        scope by instrumented code stay registered and usable."""
        for metric in self.metrics():
            metric._clear()


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-wide registry instance."""
    return _REGISTRY


def counter(name: str, help: str = "", labelnames: Sequence[str] = ()) -> Counter:
    return _REGISTRY.counter(name, help, labelnames)


def gauge(name: str, help: str = "", labelnames: Sequence[str] = ()) -> Gauge:
    return _REGISTRY.gauge(name, help, labelnames)


def histogram(name: str, help: str = "", labelnames: Sequence[str] = (),
              buckets: Optional[Iterable[float]] = None) -> Histogram:
    return _REGISTRY.histogram(name, help, labelnames, buckets)


def reset_metrics() -> None:
    _REGISTRY.reset()
