"""Process-wide metrics registry: counters and gauges
(``isoforest_tpu/telemetry/metrics.py``, copied: it is stdlib only).

Prometheus-shaped: counters end in ``_total``, and every metric carries a
fixed ``labelnames`` tuple with one series per label set. Thread-safe. With
telemetry off (:mod:`._state`) every mutator returns at once; readers always
work. The JAX package's histogram is not copied: no module of the port
records one yet.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Sequence, Tuple

from . import _state


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


class MetricsRegistry:
    """Get-or-create registry; one process-wide instance backs the module
    helpers. Re-registering a name with a different type or labelnames
    raises — a silent shape change would corrupt every existing series."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_create(self, cls, name: str, help: str, labelnames) -> _Metric:
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
                return existing
            metric = cls(name, help, labelnames)
            self._metrics[name] = metric
            return metric

    def counter(self, name: str, help: str = "", labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "", labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

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


def reset_metrics() -> None:
    _REGISTRY.reset()
