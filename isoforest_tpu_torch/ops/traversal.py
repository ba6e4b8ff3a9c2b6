"""Scoring a matrix of rows (``isoforest_tpu/ops/traversal.py``).

:func:`score_matrix` validates the width, resolves the strategy and runs the
rows through the streaming executor (:mod:`.streaming`), chunk by chunk,
each chunk through one kernel chosen by the forest's type and the strategy:

* standard forest: ``"walk"`` (O(h) node-id walk, :mod:`.walk`) or
  ``"dense"`` (gather-free level walk, :mod:`.dense`);
* extended forest: ``"walk"`` (:mod:`.ext_walk`, any k) or ``"dense"``
  (:mod:`.ext_dense`: the sparse kernel for k <= 32, the dense-table kernel
  above).

``"auto"`` is resolved by the measured autotuner
(:func:`~isoforest_tpu_torch.tuning.resolve_decision`). The JAX package pads
each batch to a power-of-two bucket to avoid XLA recompiles; the port
compiles nothing per shape and does not pad: :func:`batch_bucket` serves only
the autotuner's keys and ``model.warmup``.

:func:`standard_path_lengths` and :func:`extended_path_lengths` are the
gather walks of the JAX package (``_walk_blocks`` + ``_walk_one_standard``
/ ``_walk_one_extended``): references for the tests, not strategies.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Optional

import torch

from ..resilience import faults
from ..telemetry import _state as _telemetry_state
from ..telemetry.metrics import counter as _telemetry_counter
from ..telemetry.metrics import histogram as _telemetry_histogram
from ..telemetry.spans import set_span_attrs as _set_span_attrs
from ..telemetry.spans import span as _span
from ..utils.device import resolve_device
from ..utils.math import fma_f32, score_from_path_length
from ..utils.validation import check_nonfinite_policy, extract_features, validate_feature_vector_size
from . import dense, ext_dense, ext_walk, walk
from .streaming import StreamingExecutor, pipeline_enabled, resolve_chunk_rows
from .ext_growth import ExtendedForest
from .scoring_layout import PackedExtendedLayout, StandardLayout, pack_extended, pack_standard
from .tree_growth import StandardForest

# strategy -> (table builder, kernel wrapper returning mean path lengths)
_KERNELS = {
    "walk": (walk.walk_tables, walk.path_lengths_walk),
    "dense": (pack_standard, dense.dense_mean),
}
_EXT_KERNELS = {
    "walk": (ext_walk.walk_tables_extended, ext_walk.path_lengths_ext_walk),
    "dense": (ext_dense.hyperplane_tables, ext_dense.path_lengths_ext_dense),
}
STRATEGIES = tuple(_KERNELS)

# Scoring telemetry: host seconds of each score_matrix execution by resolved
# strategy (to the end of the executor's run: the non-finite count's read
# waits for the device, an unchecked call returns at the last enqueue), and
# rows scored. Autotune probes suppress both for their thread.
_SCORING_SECONDS = _telemetry_histogram(
    "isoforest_scoring_seconds",
    "Wall-clock seconds per score_matrix execution, by resolved strategy",
    labelnames=("strategy",),
)
_SCORED_ROWS_TOTAL = _telemetry_counter(
    "isoforest_scored_rows_total",
    "Rows scored by score_matrix, by resolved strategy",
    labelnames=("strategy",),
)

_METRICS_LOCAL = threading.local()


@contextlib.contextmanager
def suppress_scoring_metrics():
    """Suppress the per-strategy scoring histogram and counter for the
    calling thread: autotune probes never land in the serving series."""
    prev = getattr(_METRICS_LOCAL, "suppress", False)
    _METRICS_LOCAL.suppress = True
    try:
        yield
    finally:
        _METRICS_LOCAL.suppress = prev


def _scoring_metrics_on() -> bool:
    return _telemetry_state.enabled() and not getattr(_METRICS_LOCAL, "suppress", False)


def batch_bucket(n: int) -> int:
    """Power-of-two bucket (min 1024) of a row count: the autotuner's batch
    keys and ``model.warmup``'s sizes (the JAX package's formula)."""
    return max(1024, 1 << (max(int(n), 1) - 1).bit_length())

# Trees per block of the gather walk: it sums 8 trees, then adds the block
# to the running total, and divides by T at the end (traversal.py:88-103).
_TREE_BLOCK = 8


def _walk_one_standard(layout: StandardLayout, t: int, X: torch.Tensor, h: int) -> torch.Tensor:
    """Gather walk of one tree: the merged value of the row's exit leaf."""
    value, feature = layout.value[t], layout.feature[t]
    n = X.shape[0]
    node = torch.zeros(n, dtype=torch.long, device=X.device)
    out = torch.zeros(n, dtype=torch.float32, device=X.device)
    done = torch.zeros(n, dtype=torch.bool, device=X.device)
    for _ in range(h + 1):
        v = value[node]
        f = feature[node]
        leaf = f < 0
        out = torch.where(leaf & ~done, v, out)
        xv = X.gather(1, f.clamp(min=0).long()[:, None])[:, 0]
        node = torch.where(leaf | done, node, 2 * node + 1 + (xv >= v).long())
        done = done | leaf
    return out


def standard_path_lengths(forest: StandardForest, X: torch.Tensor) -> torch.Tensor:
    """Mean path length per row through the gather walk, ``f32[N]``."""
    layout = pack_standard(forest)
    total = torch.zeros(X.shape[0], dtype=torch.float32, device=X.device)
    for t0 in range(0, forest.num_trees, _TREE_BLOCK):
        trees = range(t0, min(t0 + _TREE_BLOCK, forest.num_trees))
        block = torch.stack([_walk_one_standard(layout, t, X, forest.height) for t in trees])
        total = total + block.sum(dim=0)
    return total / torch.tensor(float(forest.num_trees), dtype=torch.float32, device=X.device)


def _walk_one_extended(layout: PackedExtendedLayout, t: int, X: torch.Tensor, h: int) -> torch.Tensor:
    """Gather walk of one EIF tree: the merged value of the row's exit leaf.

    The dot is ``fma(x[idx_q], w_q, d)`` from ``d = 0`` for q = 0..k-1: what
    XLA:CPU makes of the reference's ``jnp.sum(xv * w, axis=1)`` up to at
    least k = 24 (measured; at k = 33 and 40 it reduces in another order).
    Unused coordinates (``-1``) read ``x[0]``, as in the reference.
    """
    value, indices, weights = layout.value[t], layout.indices[t], layout.weights[t]
    n = X.shape[0]
    node = torch.zeros(n, dtype=torch.long, device=X.device)
    out = torch.zeros(n, dtype=torch.float32, device=X.device)
    done = torch.zeros(n, dtype=torch.bool, device=X.device)
    for _ in range(h + 1):
        v = value[node]
        sub = indices[node]
        w = weights[node]
        leaf = sub[:, 0] < 0
        out = torch.where(leaf & ~done, v, out)
        xv = X.gather(1, sub.clamp(min=0).long())
        dot = torch.zeros(n, dtype=torch.float32, device=X.device)
        for q in range(layout.k):
            dot = fma_f32(xv[:, q], w[:, q], dot)
        node = torch.where(leaf | done, node, 2 * node + 1 + (dot >= v).long())
        done = done | leaf
    return out


def extended_path_lengths(forest: ExtendedForest, X: torch.Tensor) -> torch.Tensor:
    """Mean path length per row through the EIF gather walk, ``f32[N]``."""
    layout = pack_extended(forest)
    total = torch.zeros(X.shape[0], dtype=torch.float32, device=X.device)
    for t0 in range(0, forest.num_trees, _TREE_BLOCK):
        trees = range(t0, min(t0 + _TREE_BLOCK, forest.num_trees))
        block = torch.stack([_walk_one_extended(layout, t, X, forest.height) for t in trees])
        total = total + block.sum(dim=0)
    return total / torch.tensor(float(forest.num_trees), dtype=torch.float32, device=X.device)


def forest_min_features(forest) -> int:
    """Smallest row width the forest can walk: ``1 + max(feature id)``
    (for an extended forest, of its hyperplane coordinates)."""
    ids = forest.indices if isinstance(forest, ExtendedForest) else forest.feature
    return max(int(ids.max()) + 1, 0) if ids.numel() else 0


def score_matrix(
    forest,
    X,
    num_samples: int,
    strategy: str = "auto",
    chunk_size: Optional[int] = None,
    expected_features: Optional[int] = None,
    device=None,
    cache: Optional[dict] = None,
    nonfinite: str = "allow",
    strict: bool = False,
    timeout_s: Optional[float] = None,
    pipeline: Optional[bool] = None,
) -> torch.Tensor:
    """Outlier scores ``2^(-E[h]/c(num_samples))`` of an ``[N, F]`` matrix,
    ``f32[N]`` on ``device``, inside a ``score_matrix`` span.

    ``forest``: a :class:`StandardForest` or an :class:`ExtendedForest`.
    ``X`` (tensor, array or DataFrame) is converted and checked by
    :func:`~isoforest_tpu_torch.utils.validation.extract_features`; rows on
    the host stay there and the executor stages them to ``device`` (default:
    the card; the forest is moved there too), rows on ``device`` are chunked
    in place. ``strategy``: ``"walk"``, ``"dense"`` (trees up to height
    ``dense.DENSE_MAX_HEIGHT``) or ``"auto"``, resolved by the measured
    autotuner (:mod:`~isoforest_tpu_torch.tuning`: an ``ISOFOREST_TPU_STRATEGY``
    pin, else the persisted table, else a probe; the walk when
    ``ISOFOREST_TPU_AUTOTUNE=0``). ``expected_features`` (the model's
    training width) makes a wrong-width ``X`` a ValueError; a matrix
    narrower than the forest's highest split feature is always refused.
    ``cache``: a dict the caller keeps per forest, holding the kernel tables
    and the width floor between calls. ``nonfinite``: NaN/inf policy
    (``"warn"``/``"raise"``/``"allow"``), counted on the device chunk by
    chunk and read once.

    ``chunk_size`` (default :func:`~.streaming.resolve_chunk_rows`) bounds a
    launch; ``pipeline=False`` (or ``ISOFOREST_TPU_PIPELINE=0``) keeps
    chunking but copies each chunk synchronously. Scores are bitwise equal
    either way. ``timeout_s`` runs the call under the scoring watchdog: a
    stall raises :class:`~isoforest_tpu_torch.resilience.watchdog.WatchdogTimeout`
    and nothing is retried on another strategy. ``strict=True`` raises
    :class:`~isoforest_tpu_torch.resilience.degradation.DegradationError`
    where resolution would take the ``env_strategy_unknown`` rung.
    """
    with _span("score_matrix", requested_strategy=strategy):
        dev = resolve_device(device)
        check_nonfinite_policy(nonfinite)
        X, _ = extract_features(X, nonfinite="allow")
        if X.device.type != "cpu" and X.device != dev:
            X = X.to(dev)
        cache = {} if cache is None else cache
        if forest.device != dev:
            forest = forest.to(dev)
        if expected_features is not None:
            validate_feature_vector_size(int(X.shape[1]), expected_features)
        floor = cache.get("min_features")
        if floor is None:
            floor = cache["min_features"] = forest_min_features(forest)
        if X.shape[1] < floor:
            raise ValueError(
                f"feature vector has {X.shape[1]} features, but the forest splits on "
                f"feature index {floor - 1}: the model was trained on >= {floor} features"
            )
        n = int(X.shape[0])
        chunk = resolve_chunk_rows(chunk_size, dev.type)
        if strategy == "auto":
            from ..tuning import resolve_decision

            decision = resolve_decision(forest, X, num_samples, device=dev, chunk_rows=chunk, strict=strict,
                                        cache=cache)
            strategy = decision.strategy
            _set_span_attrs(strategy=strategy, strategy_source=decision.source, rows=n)
        else:
            if strategy not in STRATEGIES:
                raise ValueError(
                    f"unknown scoring strategy {strategy!r}; expected 'auto', "
                    + ", ".join(repr(s) for s in STRATEGIES)
                )
            _set_span_attrs(strategy=strategy, strategy_source="explicit", rows=n)
        faults.check_strategy(strategy)
        build, run = (_EXT_KERNELS if isinstance(forest, ExtendedForest) else _KERNELS)[strategy]
        tables = cache.get((strategy, dev))
        if tables is None:
            tables = cache[(strategy, dev)] = build(forest)
        executor = StreamingExecutor(
            lambda chunk_rows: run(chunk_rows, tables), chunk, device=dev, site="score_matrix",
            streaming=pipeline_enabled(pipeline), timeout_s=timeout_s, describe=f"scoring strategy {strategy!r}",
            prelude=lambda: faults.maybe_slow_collective(strategy), nonfinite=nonfinite,
        )
        t0 = time.perf_counter()
        path_lengths = executor.execute(X)
        if _scoring_metrics_on():
            _SCORING_SECONDS.observe(time.perf_counter() - t0, strategy=strategy)
            _SCORED_ROWS_TOTAL.inc(n, strategy=strategy)
        # one exp2 over all N: chunking stays bitwise neutral even where exp2
        # rounds differently by vector position on the CPU
        return score_from_path_length(path_lengths, num_samples)
