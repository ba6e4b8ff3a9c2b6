"""Recent-data reservoirs: the window a retrain trains on
(``isoforest_tpu/lifecycle/window.py``; host numpy, as there).

* :class:`DataReservoir`: a bounded FIFO of the last ``capacity`` served
  rows (and their labels, while every batch has them), in arrival order. A
  deterministic window, which keeps a refit reproducible bit for bit.
* :class:`DecayReservoir`: an exponential-decay weighted sample over an
  event-time stream: a row stamped ``t`` is kept with odds proportional to
  ``2^(t / half_life_s)``. Replacement is the Gumbel-max trick over the
  seeded splitmix64 stream of :mod:`..ops.bagging`, so the kept rows and
  their order are a function of ``(seed, fold order, event times)`` alone,
  and the JAX package's for the same.

Both are thread-safe: serving folds from its flusher while the retrain
thread snapshots.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..ops.bagging import _GOLDEN, _mix64


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a


def _check_batch(X, y) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """A batch as host float32 rows and float64 labels (a tensor on the
    card is copied once)."""
    X = np.asarray(_host(X), np.float32)
    if X.ndim != 2 or X.shape[0] == 0:
        raise ValueError(f"reservoir batches must be non-empty [N, F]; got {X.shape}")
    if y is not None:
        y = np.asarray(_host(y), np.float64).reshape(-1)
        if y.shape[0] != X.shape[0]:
            raise ValueError(f"labels must align with rows; got {y.shape[0]} labels for {X.shape[0]} rows")
    return X, y


def _check_width(kept: Optional[np.ndarray], X: np.ndarray) -> None:
    if kept is not None and X.shape[1] != kept.shape[1]:
        raise ValueError(f"reservoir feature width is {kept.shape[1]}; got a batch of width {X.shape[1]}")


class DataReservoir:
    """Bounded FIFO of recently served rows (and optional labels).

    ``fold`` appends a batch and evicts the oldest rows past ``capacity``;
    ``snapshot`` returns copies in arrival order (oldest first). Labels are
    kept only while every folded batch carries them: one unlabeled batch
    drops the label track (a partial one would misalign the AUROC gate).
    """

    def __init__(self, capacity: int) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._X: Optional[np.ndarray] = None
        self._y: Optional[np.ndarray] = None
        self._labeled = True  # until an unlabeled batch arrives

    @property
    def rows(self) -> int:
        with self._lock:
            return 0 if self._X is None else int(self._X.shape[0])

    def fold(self, X, y=None) -> None:
        X, y = _check_batch(X, y)
        with self._lock:
            _check_width(self._X, X)
            if y is None:
                self._labeled = False
                self._y = None
            if self._X is None:
                self._X = X[-self.capacity :].copy()
                if self._labeled and y is not None:
                    self._y = y[-self.capacity :].copy()
                return
            self._X = np.concatenate([self._X, X])[-self.capacity :]
            if self._labeled and y is not None:
                base = self._y if self._y is not None else np.empty((0,), np.float64)
                self._y = np.concatenate([base, y])[-self.capacity :]

    def snapshot(self) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """``(X, y_or_None)``: copies, oldest row first."""
        with self._lock:
            if self._X is None:
                return np.empty((0, 0), np.float32), None
            X = self._X.copy()
            y = self._y.copy() if (self._labeled and self._y is not None) else None
        return X, y

    def clear(self) -> None:
        with self._lock:
            self._X = None
            self._y = None
            self._labeled = True


class DecayReservoir:
    """Exponential-decay weighted reservoir over an event-time stream.

    Holds at most ``capacity`` rows. Row ``i`` (the ``i``-th ever offered)
    draws ``u_i`` from ``mix64(seed + (i+1) * golden)`` and gets the key
    ``t_i * ln(2) / half_life_s - ln(-ln(u_i))``; the ``capacity`` largest
    keys are kept, which selects row ``i`` with odds proportional to
    ``2^(t_i / half_life_s)``. :meth:`keys_for` recomputes any key.

    ``fold(X, y=None, event_ts=None)`` takes a scalar or per-row event time;
    ``None`` stamps the batch with ``clock()``, so the call is a drop-in for
    :class:`DataReservoir` in ``ModelManager.score``. Labels as in the FIFO.
    ``snapshot`` orders the kept rows by (event time, offer order).
    """

    def __init__(
        self,
        capacity: int,
        *,
        half_life_s: float = 3600.0,
        seed: int = 0,
        clock: Callable[[], float] = time.time,
    ) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if not (half_life_s > 0) or not math.isfinite(half_life_s):
            raise ValueError(f"half_life_s must be finite and > 0, got {half_life_s}")
        self.capacity = int(capacity)
        self.half_life_s = float(half_life_s)
        self.seed = int(seed)
        self._clock = clock
        self._lock = threading.Lock()
        self._labeled = True  # until an unlabeled batch arrives
        self._offered = 0  # rows ever offered: the hash stream's coordinate
        self._X: Optional[np.ndarray] = None  # [K, F] kept rows
        self._y: Optional[np.ndarray] = None  # [K] kept labels
        self._ts = np.empty((0,), np.float64)  # [K] kept event times
        self._key = np.empty((0,), np.float64)  # [K] kept priority keys
        self._seq = np.empty((0,), np.int64)  # [K] kept offer indices

    @property
    def rows(self) -> int:
        with self._lock:
            return 0 if self._X is None else int(self._X.shape[0])

    def keys_for(self, start: int, event_ts: np.ndarray) -> np.ndarray:
        """The priority keys of rows ``start .. start+len(event_ts)``."""
        seq = np.arange(start, start + len(event_ts), dtype=np.uint64)
        h = _mix64(np.uint64(self.seed & 0xFFFFFFFFFFFFFFFF) + (seq + np.uint64(1)) * _GOLDEN)
        # a 53-bit uniform in (0, 1), never 0 or 1: the double log is finite
        u = ((h >> np.uint64(11)).astype(np.float64) + 0.5) * 2.0**-53
        gumbel = -np.log(-np.log(u))
        return np.asarray(event_ts, np.float64) * (math.log(2.0) / self.half_life_s) + gumbel

    def fold(self, X, y=None, event_ts=None) -> None:
        X, y = _check_batch(X, y)
        n = int(X.shape[0])
        if event_ts is None:
            ts = np.full((n,), float(self._clock()), np.float64)
        else:
            ts = np.asarray(event_ts, np.float64).reshape(-1)
            if ts.shape[0] == 1:
                ts = np.full((n,), float(ts[0]), np.float64)
            elif ts.shape[0] != n:
                raise ValueError(f"event_ts must be scalar or per-row; got {ts.shape[0]} timestamps for {n} rows")
        with self._lock:
            _check_width(self._X, X)
            key = self.keys_for(self._offered, ts)
            seq = np.arange(self._offered, self._offered + n, dtype=np.int64)
            self._offered += n
            if y is None:
                self._labeled = False
                self._y = None
            if self._X is None:
                all_X = X.copy()
                all_y = y.copy() if (self._labeled and y is not None) else None
                all_ts, all_key, all_seq = ts, key, seq
            else:
                all_X = np.concatenate([self._X, X])
                if self._labeled and y is not None:
                    base = self._y if self._y is not None else np.empty((0,), np.float64)
                    all_y = np.concatenate([base, y])
                else:
                    all_y = None
                all_ts = np.concatenate([self._ts, ts])
                all_key = np.concatenate([self._key, key])
                all_seq = np.concatenate([self._seq, seq])
            if all_X.shape[0] > self.capacity:
                # the top-capacity keys; lexsort's last key is primary, and a
                # (measure-zero) key tie keeps the newer row
                order = np.lexsort((-all_seq, -all_key))[: self.capacity]
                all_X = all_X[order]
                all_y = all_y[order] if all_y is not None else None
                all_ts, all_key, all_seq = all_ts[order], all_key[order], all_seq[order]
            self._X, self._y = all_X, all_y
            self._ts, self._key, self._seq = all_ts, all_key, all_seq

    def snapshot(self) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """``(X, y_or_None)``: copies ordered by (event time, offer order),
        oldest first."""
        with self._lock:
            if self._X is None:
                return np.empty((0, 0), np.float32), None
            order = np.lexsort((self._seq, self._ts))
            X = self._X[order].copy()
            y = self._y[order].copy() if (self._labeled and self._y is not None) else None
        return X, y

    def clear(self) -> None:
        """Drop the kept rows; the offer counter keeps advancing, so the hash
        stream never repeats a coordinate."""
        with self._lock:
            self._X = None
            self._y = None
            self._ts = np.empty((0,), np.float64)
            self._key = np.empty((0,), np.float64)
            self._seq = np.empty((0,), np.int64)
            self._labeled = True
