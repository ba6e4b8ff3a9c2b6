"""Scoring a matrix of rows (``isoforest_tpu/ops/traversal.py``).

:func:`score_matrix` validates the width, resolves the strategy and runs the
rows through the streaming executor (:mod:`.streaming`), chunk by chunk,
each chunk through one kernel chosen by the forest's type and the strategy:

* standard forest: ``"walk"`` (O(h) node-id walk, :mod:`.walk`) or
  ``"dense"`` (gather-free level walk, :mod:`.dense`);
* extended forest: ``"walk"`` (:mod:`.ext_walk`, any k) or ``"dense"``
  (:mod:`.ext_dense`: the sparse kernel for k <= 32, the dense-table kernel
  above);
* either: ``"q16"``, the rank walk over the quantized plane
  (:func:`standard_path_lengths_q`, :func:`extended_path_lengths_q`) in
  torch ops, as the JAX package computes it in XLA; a forest outside the
  plane's fences takes the ``q16_unsupported`` rung onto ``"walk"``.

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
from ..resilience.degradation import degrade
from ..telemetry import _state as _telemetry_state
from ..telemetry import resources as _resources
from ..telemetry.metrics import counter as _telemetry_counter
from ..telemetry.metrics import histogram as _telemetry_histogram
from ..telemetry.spans import set_span_attrs as _set_span_attrs
from ..telemetry.spans import span as _span
from ..utils import monitoring
from ..utils.device import resolve_device
from ..utils.math import fma_f32, height_of, score_from_path_length
from ..utils.validation import check_nonfinite_policy, extract_features, validate_feature_vector_size
from . import dense, ext_dense, ext_walk, walk
from .streaming import StreamingExecutor, pipeline_enabled, resolve_chunk_rows
from .ext_growth import ExtendedForest
from .scoring_layout import (
    _Q16_FEATURE_SENTINEL,
    PackedExtendedLayout,
    QuantizedExtendedLayout,
    QuantizedStandardLayout,
    StandardLayout,
    pack_extended,
    pack_extended_q,
    pack_standard,
    pack_standard_q,
    quantized_unsupported_reason,
)
from .tree_growth import StandardForest

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


def _sum_trees(block: torch.Tensor) -> torch.Tensor:
    """A block's path lengths ``[G, C]`` summed over its trees in tree order,
    ``((b0 + b1) + b2) + ...``: XLA:CPU's order for the JAX package's
    ``jnp.sum(pl, axis=0)`` at every C. torch's ``sum(dim=0)`` takes
    another order at some widths (C = 300, 1,500 and 70,000 on the CPU), so
    its bits would move with the chunking and the device."""
    total = block[0]
    for row in block[1:]:
        total = total + row
    return total


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
        total = total + _sum_trees(block)
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
        total = total + _sum_trees(block)
    return total / torch.tensor(float(forest.num_trees), dtype=torch.float32, device=X.device)


# -- the quantized (q16) walks (``traversal.py:228-378``) -------------------
# Rows binarize once per chunk to threshold ranks; each step reads one
# 32-bit record and compares ranks, ``rx > code``, which is exactly
# ``x >= threshold``. The 8 trees of a block walk together on ``[8, C]``
# tensors, and each block is summed over its trees (:func:`_sum_trees`) and
# added to the total, as the gather walk sums: the q16 walk equals it
# bitwise, on the CPU and on the card, however the rows are chunked. NaN rows
# are the documented exception: a NaN ranks past every edge and goes right,
# where the float compare sends it left.


def binarize_ranks(edges: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """``rx[c, f]`` = number of edges ``<= X[c, f]``, int32 ``[C, F]``
    (``side='right'`` counts the edge itself: ``rx > code`` iff ``x >=
    threshold``)."""
    return torch.searchsorted(edges, X.contiguous(), right=True, out_int32=True)


def _walk_block_q(packed: torch.Tensor, rx_t: torch.Tensor, lut: torch.Tensor, h: int) -> torch.Tensor:
    """Rank walk of a block of trees together: ``packed`` int32 ``[G, M]``,
    ``rx_t`` the ranks transposed ``[F, C]``; each tree's exit-leaf value,
    ``f32[G, C]``."""
    g, c = packed.shape[0], rx_t.shape[1]
    node = torch.zeros((g, c), dtype=torch.long, device=rx_t.device)
    out = torch.zeros((g, c), dtype=torch.float32, device=rx_t.device)
    done = torch.zeros((g, c), dtype=torch.bool, device=rx_t.device)
    for _ in range(h + 1):
        rec = packed.gather(1, node)
        f = rec & _Q16_FEATURE_SENTINEL
        code = (rec >> 16) & _Q16_FEATURE_SENTINEL
        leaf = f == _Q16_FEATURE_SENTINEL
        # an internal node's code is a rank, not a LUT index
        out = torch.where(leaf & ~done, lut[torch.where(leaf, code, 0).long()], out)
        rxv = rx_t.gather(0, torch.where(leaf, 0, f).long())
        node = torch.where(leaf | done, node, 2 * node + 1 + (rxv > code).long())
        done = done | leaf
    return out


def standard_path_lengths_q(forest: Optional[StandardForest], X: torch.Tensor,
                            qlayout: Optional[QuantizedStandardLayout] = None) -> torch.Tensor:
    """Mean path length per row through the q16 plane, ``f32[N]``; bitwise
    equal to :func:`standard_path_lengths` on rows without NaN. The forest
    is read only to pack ``qlayout`` when none is given."""
    if qlayout is None:
        qlayout = pack_standard_q(forest)
    h = height_of(qlayout.packed.shape[1])
    rx_t = binarize_ranks(qlayout.edges, X).t().contiguous()
    t_n = qlayout.num_trees
    total = torch.zeros(X.shape[0], dtype=torch.float32, device=X.device)
    for t0 in range(0, t_n, _TREE_BLOCK):
        block = _walk_block_q(qlayout.packed[t0 : t0 + _TREE_BLOCK], rx_t, qlayout.lut, h)
        total = total + _sum_trees(block)
    return total / torch.tensor(float(t_n), dtype=torch.float32, device=X.device)


def _walk_block_q_extended(indices: torch.Tensor, weights: torch.Tensor, value: torch.Tensor,
                           X_t: torch.Tensor, h: int) -> torch.Tensor:
    """EIF walk of a block of trees together on the q16 plane: ``indices``
    int16 / ``weights`` f32 ``[G, M, k]``, ``value`` f32 ``[G, M]``, ``X_t``
    the rows transposed ``[F, C]``; each tree's exit-leaf value, ``f32[G,
    C]``. The dot is the gather walk's FMA chain from 0."""
    g, m, k = indices.shape
    c = X_t.shape[1]
    node = torch.zeros((g, c), dtype=torch.long, device=X_t.device)
    out = torch.zeros((g, c), dtype=torch.float32, device=X_t.device)
    done = torch.zeros((g, c), dtype=torch.bool, device=X_t.device)
    flat_idx, flat_w = indices.reshape(g * m, k), weights.reshape(g * m, k)
    base = (torch.arange(g, device=X_t.device) * m)[:, None]
    for _ in range(h + 1):
        v = value.gather(1, node)
        at = (base + node).reshape(-1)
        sub = flat_idx[at].reshape(g, c, k).long()
        w = flat_w[at].reshape(g, c, k)
        leaf = sub[..., 0] < 0
        out = torch.where(leaf & ~done, v, out)
        dot = torch.zeros((g, c), dtype=torch.float32, device=X_t.device)
        for q in range(k):
            # unused coordinates (-1) read x[0], as in the reference
            dot = fma_f32(X_t.gather(0, sub[..., q].clamp(min=0)), w[..., q], dot)
        node = torch.where(leaf | done, node, 2 * node + 1 + (dot >= v).long())
        done = done | leaf
    return out


def extended_path_lengths_q(forest: Optional[ExtendedForest], X: torch.Tensor,
                            qlayout: Optional[QuantizedExtendedLayout] = None) -> torch.Tensor:
    """Mean path length per row through the EIF q16 plane (int16 indices,
    float32 weights and offsets), ``f32[N]``: the float32 arithmetic of
    :func:`extended_path_lengths`, so the two are bitwise equal. The forest
    is read only to pack ``qlayout`` when none is given."""
    if qlayout is None:
        qlayout = pack_extended_q(forest)
    h = height_of(qlayout.value.shape[1])
    X_t = X.t().contiguous()
    t_n = qlayout.num_trees
    total = torch.zeros(X.shape[0], dtype=torch.float32, device=X.device)
    for t0 in range(0, t_n, _TREE_BLOCK):
        trees = slice(t0, t0 + _TREE_BLOCK)
        block = _walk_block_q_extended(qlayout.indices[trees], qlayout.weights[trees], qlayout.value[trees], X_t, h)
        total = total + _sum_trees(block)
    return total / torch.tensor(float(t_n), dtype=torch.float32, device=X.device)


def path_lengths_q(forest, X: torch.Tensor, qlayout=None) -> torch.Tensor:
    if isinstance(forest, ExtendedForest):
        return extended_path_lengths_q(forest, X, qlayout)
    return standard_path_lengths_q(forest, X, qlayout)


def standard_path_lengths_dense_q(forest: StandardForest, X: torch.Tensor,
                                  qlayout: Optional[QuantizedStandardLayout] = None) -> torch.Tensor:
    """The dense level walk over the q16 plane (``dense_traversal.py:232``),
    ``f32[N]``: per tree, the go-right bits of a level are ``rx[c, feat] >
    code`` and the path length is the sum over levels of the reached
    leaf's LUT value; trees add one by one, then the total is divided by
    T, as the JAX function adds them (its ``_TREE_BLOCK`` of 1). Each row
    reaches one slot a level, so the level sums are exact; the compare
    picks ``rx`` by a gather where the JAX function selects or contracts
    a one-hot, with the same bits. No strategy runs it: ``strategy="q16"``
    runs the rank walk on every device, as the JAX package does off the
    TPU, and only the tests call this function."""
    if qlayout is None:
        qlayout = pack_standard_q(forest)
    h = forest.height
    c = X.shape[0]
    rx = binarize_ranks(qlayout.edges, X)
    feat_u = qlayout.packed & _Q16_FEATURE_SENTINEL
    feature = torch.where(feat_u == _Q16_FEATURE_SENTINEL, -1, feat_u)
    code = (qlayout.packed >> 16) & _Q16_FEATURE_SENTINEL
    internal = feature >= 0
    leaf_value = torch.where(internal, 0.0, qlayout.lut[torch.where(internal, 0, code).long()])
    total = torch.zeros(c, dtype=torch.float32, device=X.device)
    for t in range(qlayout.num_trees):
        tree_total = torch.zeros(c, dtype=torch.float32, device=X.device)
        reach = torch.ones((c, 1), dtype=torch.bool, device=X.device)
        for level in range(h + 1):
            level_slots = slice((1 << level) - 1, (2 << level) - 1)
            tree_total = tree_total + torch.where(reach, leaf_value[t, level_slots][None, :], 0.0).sum(dim=1)
            if level < h:
                go_right = rx[:, feature[t, level_slots].clamp(min=0).long()] > code[t, level_slots][None, :]
                alive = reach & internal[t, level_slots][None, :]
                reach = torch.stack([alive & ~go_right, alive & go_right], dim=2).reshape(c, -1)
        total = total + tree_total
    return total / torch.tensor(float(qlayout.num_trees), dtype=torch.float32, device=X.device)


# strategy -> (table builder, chunk function returning mean path lengths)
_KERNELS = {
    "walk": (walk.walk_tables, walk.path_lengths_walk),
    "dense": (pack_standard, dense.dense_mean),
    "q16": (pack_standard_q, lambda X, qlayout: standard_path_lengths_q(None, X, qlayout)),
}
_EXT_KERNELS = {
    "walk": (ext_walk.walk_tables_extended, ext_walk.path_lengths_ext_walk),
    "dense": (ext_dense.hyperplane_tables, ext_dense.path_lengths_ext_dense),
    "q16": (pack_extended_q, lambda X, qlayout: extended_path_lengths_q(None, X, qlayout)),
}
STRATEGIES = tuple(_KERNELS)


def check_strategy_name(strategy: str) -> None:
    """Refuse a strategy the port does not serve (the JAX package's
    ``gather``, ``pallas`` and ``native`` among them) with a ValueError."""
    if strategy != "auto" and strategy not in STRATEGIES:
        raise ValueError(
            f"unknown scoring strategy {strategy!r}; expected 'auto', "
            + ", ".join(repr(s) for s in STRATEGIES)
        )


def forest_min_features(forest) -> int:
    """Smallest row width the forest can walk: ``1 + max(feature id)``
    (for an extended forest, of its hyperplane coordinates)."""
    ids = forest.indices if isinstance(forest, ExtendedForest) else forest.feature
    return max(int(ids.max()) + 1, 0) if ids.numel() else 0


def scoring_tables(forest, strategy: str, device, cache: dict):
    """The tables of ``strategy`` for ``forest`` on ``device``, built on
    first use into the caller's per-forest ``cache`` under ``(strategy,
    device)``: each strategy keeps its own entry, so a model serving both
    planes keeps both. A build reports its seconds as a
    ``TABLE_BUILD_EVENT`` (:mod:`..utils.monitoring`), which the resource
    plane counts as a compile."""
    tables = cache.get((strategy, device))
    if tables is None:
        build = (_EXT_KERNELS if isinstance(forest, ExtendedForest) else _KERNELS)[strategy][0]
        t0 = time.perf_counter()
        tables = build(forest)
        monitoring.record_event_duration_secs(monitoring.TABLE_BUILD_EVENT, time.perf_counter() - t0,
                                              key=f"tables:{strategy}")
        cache[(strategy, device)] = tables
    return tables


def _path_length_executor(forest, strategy: str, *, device: torch.device, cache: dict, rows: int,
                          chunk_rows: int, pipeline: Optional[bool], site: str, timeout_s: Optional[float],
                          nonfinite: str, nonfinite_counts: Optional[list]) -> StreamingExecutor:
    """The executor of one named strategy's kernel over ``forest`` (on
    ``device``), its tables built into ``cache`` under ``(strategy,
    device)`` before it returns, so the caller times the scoring alone."""
    faults.check_strategy(strategy)
    _, run = (_EXT_KERNELS if isinstance(forest, ExtendedForest) else _KERNELS)[strategy]
    with _resources.compile_scope(site, key=f"rows={rows}"):
        tables = scoring_tables(forest, strategy, device, cache)
    return StreamingExecutor(
        lambda chunk_rows: run(chunk_rows, tables), chunk_rows, device=device, site=site,
        streaming=pipeline_enabled(pipeline), timeout_s=timeout_s, describe=f"scoring strategy {strategy!r}",
        prelude=lambda: faults.maybe_slow_collective(strategy), nonfinite=nonfinite,
        nonfinite_counts=nonfinite_counts,
    )


def mean_path_lengths(forest, X: torch.Tensor, strategy: str, *, device: torch.device, cache: dict,
                      chunk_rows: int, pipeline: Optional[bool] = None, site: str = "score_matrix",
                      timeout_s: Optional[float] = None, nonfinite: str = "allow",
                      nonfinite_counts: Optional[list] = None) -> torch.Tensor:
    """Mean path length of every row of ``X`` (validated ``[N, F]`` rows on
    the host or on ``device``) through the kernel of one named strategy,
    ``f32[N]`` on ``device``, streamed in chunks of ``chunk_rows`` under
    ``site``: the kernel path of :func:`score_matrix`, which sharded scoring
    runs once a shard (:mod:`..parallel.sharded`). ``forest`` lies on
    ``device``; its tables are built once into ``cache`` under ``(strategy,
    device)``. ``nonfinite_counts``: as
    :class:`~.streaming.StreamingExecutor`'s."""
    return _path_length_executor(
        forest, strategy, device=device, cache=cache, rows=int(X.shape[0]), chunk_rows=chunk_rows,
        pipeline=pipeline, site=site, timeout_s=timeout_s, nonfinite=nonfinite,
        nonfinite_counts=nonfinite_counts,
    ).execute(X)


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
    ``dense.DENSE_MAX_HEIGHT``), ``"q16"`` or ``"auto"``, resolved by the
    measured autotuner (:mod:`~isoforest_tpu_torch.tuning`: an ``ISOFOREST_TPU_STRATEGY``
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
    where resolution would take the ``env_strategy_unknown`` rung, or where
    ``"q16"`` meets a forest outside the quantized plane's fences (the
    ``q16_unsupported`` rung, which otherwise scores with the walk).
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
            check_strategy_name(strategy)
            _set_span_attrs(strategy=strategy, strategy_source="explicit", rows=n)
        if strategy == "q16":
            reason = quantized_unsupported_reason(forest, cache)
            if reason is not None:
                # the JAX package lands on its gather walk, a test reference here
                strategy = degrade("q16_unsupported", "q16", "walk", strict=strict,
                                   detail=f"strategy='q16' does not cover this forest ({reason}); "
                                          "scoring with the walk strategy instead")
                _set_span_attrs(strategy=strategy)
        executor = _path_length_executor(
            forest, strategy, device=dev, cache=cache, rows=n, chunk_rows=chunk, pipeline=pipeline,
            site="score_matrix", timeout_s=timeout_s, nonfinite=nonfinite, nonfinite_counts=None,
        )
        t0 = time.perf_counter()
        path_lengths = executor.execute(X)
        if _scoring_metrics_on():
            _SCORING_SECONDS.observe(time.perf_counter() - t0, strategy=strategy)
            _SCORED_ROWS_TOTAL.inc(n, strategy=strategy)
        # one exp2 over all N: chunking stays bitwise neutral even where exp2
        # rounds differently by vector position on the CPU
        return score_from_path_length(path_lengths, num_samples)
