"""Tree-parallel growth and row-parallel scoring over a mesh
(``isoforest_tpu/parallel/sharded.py``).

The reference's three distribution primitives (SURVEY.md §5.8) become:
Spark's ``collect()`` of trees, a gather of fixed-shape tree tensors
(:func:`~.mesh.gather_shards`); the forest's ``broadcast``, one copy of the
forest and of its kernel tables per distinct device; the row partitions,
equal row blocks, one a shard.

* :func:`sharded_grow_forest` / :func:`sharded_grow_extended_forest`: the
  tree axis is padded to a multiple of the shard count by repeating the last
  tree (:func:`_pad_axis`) and split into equal slabs; each shard grows its
  slab with the port's growth on its device, over one copy of X per distinct
  device; the slabs are gathered in shard order and the pad sliced off.
  Per-tree keys make this bitwise equal to one device's growth.
* :func:`sharded_score`: the rows are padded to a multiple of the shard
  count by repeating the last row and split into equal blocks; each shard
  runs its block through the port's kernel path
  (:func:`~..ops.traversal.mean_path_lengths`) on its device, streamed in
  chunks (the call's chunk, a multiple of the shard count, split over the
  shards) when the rows lie on the host and span several chunks
  (:func:`_should_stream`). The mean path lengths are gathered in row order
  and turned into scores by one ``exp2`` over all N, as
  :func:`~..ops.traversal.score_matrix` does: scoring is row-independent, so
  the scores equal the unsharded ones bit for bit.
* :func:`sharded_score_2d`: the forest is padded with NEUTRAL trees
  (:func:`_pad_trees_neutral`, each adds exactly 0) and sharded over
  ``trees``, the rows over ``data``; each shard computes ``mean path length
  of its trees x its tree count`` and the partial sums add over the
  ``trees`` axis (a loop in mesh order in one process, an all-reduce on the
  row's subgroup across processes), then divide by the true T. Not bitwise
  to one launch: another sum order.

The kernel tables are built once per (forest, device) into the caller's
per-forest ``cache`` (a model's ``_cache``), under the keys the unsharded
path uses, so a mesh on the model's own card reuses the model's tables.
Strategy resolution (:func:`resolve_sharded_strategy`) pools the kernels
``walk`` (K1, K3) and ``dense`` (K2, K4, K5): the JAX package pools its two
``shard_map``-jittable formulations, ``gather`` and ``dense``. On a mesh of
CUDA devices every shard runs the kernels or raises; on the CPU their plain
versions, as every path of the port does. No watchdog is armed here.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.ext_growth import ExtendedForest, grow_extended_forest
from ..ops.streaming import pipeline_enabled, resolve_chunk_rows
from ..ops.traversal import forest_min_features, mean_path_lengths
from ..ops.tree_growth import StandardForest, grow_forest
from ..utils.math import score_from_path_length
from ..utils.validation import check_nonfinite_policy, count_non_finite, extract_features, report_non_finite
from .mesh import DATA_AXIS, TREES_AXIS, Mesh, gather_shards, reduce_local, reduce_shards


def resolve_sharded_strategy(mesh: Mesh, score_strategy: str = "auto", forest=None, X=None,
                             num_samples: Optional[int] = None, num_rows: Optional[int] = None,
                             cache: Optional[dict] = None) -> str:
    """The kernel strategy of sharded scoring, from the pool ``walk`` and
    ``dense``. ``"auto"``: with ``forest``, ``X`` and ``num_samples`` the
    measured autotuner restricted to the pool, its batch bucket keyed on the
    rows one shard scores (``num_rows``); without a forest (the train step
    resolves before it has one) an eligible ``ISOFOREST_TPU_STRATEGY``
    pin, else the static default ``walk`` (the measured winner at 1M rows for
    both forest types), emitted as a ``fallback`` decision. A pin outside the
    pool warns once through the ``shard_pin_ineligible`` rung and is ignored.
    Another explicit strategy than ``auto``, ``walk`` or ``dense`` raises
    ValueError."""
    from ..tuning import SHARDED_STRATEGIES, resolve_decision

    if score_strategy == "auto":
        return resolve_decision(forest, X, num_samples, device=mesh.first_device, cache=cache,
                                restrict=SHARDED_STRATEGIES, num_rows=num_rows, site="sharded").strategy
    if score_strategy not in ("walk", "dense"):
        raise ValueError(f"score_strategy must be 'auto', 'walk' or 'dense' (the sharded pool), "
                         f"got {score_strategy!r}")
    return score_strategy


def _pad_axis(t: torch.Tensor, axis: int, multiple: int):
    """``(t, pad)``: ``axis`` padded up to a multiple by repeating the last
    slice (padding trees are grown and sliced off; padding rows are scored
    and dropped)."""
    size = t.shape[axis]
    pad = (-size) % multiple
    if pad == 0:
        return t, 0
    last = t.narrow(axis, size - 1, 1)
    reps = [1] * t.dim()
    reps[axis] = pad
    return torch.cat([t, last.repeat(*reps)], dim=axis), pad


def _pad_trees_neutral(forest, multiple: int):
    """``(forest, pad)``: the tree axis padded with NEUTRAL trees, a single
    root leaf of ``numInstances`` 1, so ``c(1) = 0`` and each adds exactly 0
    path length to every row. The trees flow into a sum, so repeating the
    last tree (:func:`_pad_axis`) would count it twice."""
    pad = (-forest.num_trees) % multiple
    if pad == 0:
        return forest, 0

    def extend(a: torch.Tensor, fill) -> torch.Tensor:
        return torch.cat([a, torch.full((pad,) + tuple(a.shape[1:]), fill, dtype=a.dtype, device=a.device)])

    if isinstance(forest, StandardForest):
        return StandardForest(feature=extend(forest.feature, -1), threshold=extend(forest.threshold, 0.0),
                              num_instances=extend(forest.num_instances, 1)), pad
    return ExtendedForest(indices=extend(forest.indices, -1), weights=extend(forest.weights, 0.0),
                          offset=extend(forest.offset, 0.0), num_instances=extend(forest.num_instances, 1)), pad


def _grow_sharded(mesh: Mesh, tree_keys, X, bag_idx, feat_idx, height: int, extension_level):
    n = mesh.size
    tree_keys, pad = _pad_axis(tree_keys, 0, n)
    bag_idx, _ = _pad_axis(bag_idx, 0, n)
    feat_idx, _ = _pad_axis(feat_idx, 0, n)
    slab = tree_keys.shape[0] // n
    X_on: dict = {}  # one copy of X per distinct device, shared by its shards
    parts = []
    for s in mesh.local_shards:
        dev = mesh.flat_devices[s]
        Xd = X_on.get(dev)
        if Xd is None:
            Xd = X_on[dev] = X.to(dev)
        trees = slice(s * slab, (s + 1) * slab)
        args = (tree_keys[trees].to(dev), Xd, bag_idx[trees].to(dev), feat_idx[trees].to(dev), height)
        parts.append(grow_forest(*args) if extension_level is None
                     else grow_extended_forest(*args, extension_level))
    cls = StandardForest if extension_level is None else ExtendedForest
    forest = cls(*(gather_shards(mesh, [getattr(p, f) for p in parts]) for f in cls._fields))
    if pad:
        forest = cls(*(a[: a.shape[0] - pad] for a in forest))
    return forest


def sharded_grow_forest(mesh: Mesh, tree_keys, X, bag_idx, feat_idx, height: int) -> StandardForest:
    """Tree-parallel growth: each shard grows ``T / shards`` trees (the tree
    axis padded) over its device's copy of X; the forest lands on the mesh's
    first local device, bitwise equal to :func:`~..ops.tree_growth.grow_forest`."""
    return _grow_sharded(mesh, tree_keys, X, bag_idx, feat_idx, height, None)


def sharded_grow_extended_forest(mesh: Mesh, tree_keys, X, bag_idx, feat_idx, height: int,
                                 extension_level: int) -> ExtendedForest:
    """:func:`sharded_grow_forest` of the extended forest."""
    return _grow_sharded(mesh, tree_keys, X, bag_idx, feat_idx, height, extension_level)


def _should_stream(pipeline: Optional[bool], n: int, chunk_rows: int, X: torch.Tensor) -> bool:
    """Stream when the batch spans several chunks and the pipeline is on;
    rows already on a card stay single-shot unless ``pipeline=True`` forces
    the chunked path (bounding a call's working set)."""
    if not pipeline_enabled(pipeline) or n <= chunk_rows:
        return False
    return pipeline is True or X.device.type == "cpu"


def _row_plan(mesh: Mesh, X: torch.Tensor, parts: int, pipeline: Optional[bool], chunk_rows: Optional[int]):
    """``(block, step)``: the rows of each of ``parts`` equal row blocks,
    and the rows a block streams a step: the call's chunk (a multiple of
    ``parts``) split over the blocks when :func:`_should_stream`, else the
    whole block."""
    n = int(X.shape[0])
    chunk = resolve_chunk_rows(chunk_rows, mesh.first_device.type, multiple=parts)
    block = -(-n // parts)
    return block, (chunk // parts if _should_stream(pipeline, n, chunk, X) else block)


def _rows_block(X: torch.Tensor, index: int, block: int) -> torch.Tensor:
    """Rows ``[index * block, (index + 1) * block)`` of ``X``, padded with
    copies of X's last row past its end."""
    n = X.shape[0]
    lo, hi = min(index * block, n), min((index + 1) * block, n)
    rows = X[lo:hi]
    if hi - lo < block:
        rows = torch.cat([rows, X[n - 1 :].expand(block - (hi - lo), X.shape[1])])
    return rows


def _on_device(forest, dev: torch.device, cache: dict):
    """The forest on ``dev``: itself, or a copy kept in ``cache``."""
    if forest.device == dev:
        return forest
    key = ("forest", dev)
    if key not in cache:
        cache[key] = forest.to(dev)
    return cache[key]


def _prepare(forest, X, cache: Optional[dict]):
    """``(X, cache)``: X as validated ``[N, F]`` float32 rows, checked
    against the forest's highest split feature."""
    X, _ = extract_features(X, nonfinite="allow")
    cache = {} if cache is None else cache
    floor = cache.get("min_features")
    if floor is None:
        floor = cache["min_features"] = forest_min_features(forest)
    if X.shape[1] < floor:
        raise ValueError(
            f"feature vector has {X.shape[1]} features, but the forest splits on "
            f"feature index {floor - 1}: the model was trained on >= {floor} features"
        )
    return X, cache


def _report_non_finite(mesh: Mesh, counts: list, X: torch.Tensor, pad_rows: int, policy: str) -> None:
    """Apply ``policy`` once to the non-finite values the shards counted on
    their devices (``counts``, unread): this rank's, less those of its pad
    rows (copies of X's last row), summed over the ranks."""
    if policy == "allow":
        return
    dev = mesh.first_device
    total = reduce_local(counts, "sum", dev) if counts else torch.zeros((), dtype=torch.int64, device=dev)
    if pad_rows:
        total = total - count_non_finite(X[-1:]).to(dev) * pad_rows
    if mesh.distributed:
        total = reduce_shards(mesh, [total], "sum")
    report_non_finite(int(total), policy)


def _local_path_lengths(mesh: Mesh, forest, X: torch.Tensor, strategy: str, *, pipeline: Optional[bool] = None,
                        chunk_rows: Optional[int] = None, cache: Optional[dict] = None,
                        nonfinite: str = "allow") -> list:
    """This rank's shards' mean path length blocks, in shard order, each
    ``f32[N / shards]`` (the rows padded) on its shard's device: row block
    ``s`` of ``X`` (prepared rows, N > 0) scored on flat shard ``s`` with
    the forest replicated. ``nonfinite`` applies once, over every rank, to
    the NaN/inf values the shards count on their devices."""
    n = int(X.shape[0])
    block, step = _row_plan(mesh, X, mesh.size, pipeline, chunk_rows)
    parts, counts = [], []
    for s in mesh.local_shards:
        dev = mesh.flat_devices[s]
        parts.append(mean_path_lengths(_on_device(forest, dev, cache), _rows_block(X, s, block), strategy,
                                       device=dev, cache=cache, chunk_rows=step, pipeline=pipeline,
                                       site="sharded", nonfinite=nonfinite, nonfinite_counts=counts))
    pad_rows = sum(block - max(0, min(block, n - s * block)) for s in mesh.local_shards)
    _report_non_finite(mesh, counts, X, pad_rows, nonfinite)
    return parts


def sharded_path_lengths(mesh: Mesh, forest, X, strategy: str, *, pipeline: Optional[bool] = None,
                         chunk_rows: Optional[int] = None, cache: Optional[dict] = None,
                         nonfinite: str = "allow") -> torch.Tensor:
    """Mean path length of every row, ``f32[N]`` on the mesh's first local
    device, rows sharded over every shard and the forest replicated
    (module docstring), the blocks gathered in row order; ``strategy`` is
    ``"walk"`` or ``"dense"``. ``nonfinite`` (``"warn"``, ``"raise"``,
    ``"allow"``) applies once to the NaN/inf values the shards count on
    their devices."""
    check_nonfinite_policy(nonfinite)
    X, cache = _prepare(forest, X, cache)
    n = int(X.shape[0])
    if n == 0:
        return torch.zeros(0, dtype=torch.float32, device=mesh.first_device)
    parts = _local_path_lengths(mesh, forest, X, strategy, pipeline=pipeline, chunk_rows=chunk_rows,
                                cache=cache, nonfinite=nonfinite)
    return gather_shards(mesh, parts)[:n]


def sharded_score(mesh: Mesh, forest, X, num_samples: int, score_strategy: str = "auto", *,
                  pipeline: Optional[bool] = None, chunk_rows: Optional[int] = None,
                  cache: Optional[dict] = None, nonfinite: str = "allow") -> torch.Tensor:
    """Row-parallel scoring: rows sharded over every shard of the mesh, the
    forest replicated. Scores ``f32[N]`` on the mesh's first local device,
    bit for bit the unsharded ones.

    ``pipeline=None`` streams host rows that span several chunks; ``True``
    chunks rows on a card too; ``False`` copies each shard's block in one
    piece. ``chunk_rows`` (default: the executor's policy) is rounded down
    to a multiple of the shard count; each shard streams ``chunk_rows /
    shards`` rows a step. ``cache``: the caller's per-forest dict of kernel
    tables (a model's ``_cache``). ``nonfinite``: the NaN/inf policy,
    counted on the devices and applied once."""
    X, cache = _prepare(forest, X, cache)
    _, step = _row_plan(mesh, X, mesh.size, pipeline, chunk_rows)
    strategy = resolve_sharded_strategy(mesh, score_strategy, forest=forest, X=X, num_samples=num_samples,
                                        num_rows=max(step, 1), cache=cache)
    pl = sharded_path_lengths(mesh, forest, X, strategy, pipeline=pipeline, chunk_rows=chunk_rows, cache=cache,
                              nonfinite=nonfinite)
    # one exp2 over all N, as score_matrix: bitwise neutral to the sharding
    return score_from_path_length(pl, num_samples)


def sharded_score_2d(mesh: Mesh, forest, X, num_samples: int, score_strategy: str = "auto", *,
                     pipeline: Optional[bool] = None, chunk_rows: Optional[int] = None,
                     cache: Optional[dict] = None, nonfinite: str = "allow") -> torch.Tensor:
    """2-D (trees x rows) sharded scoring: the forest stays sharded over the
    ``trees`` axis (each shard holds ``T / trees`` trees and their tables),
    the rows over ``data``; per-row partial sums add over the ``trees``
    axis in mesh order, then divide by the true tree count. Scores ``f32[N]``
    on the mesh's first local device, equal to the unsharded ones up to the
    sum order. ``pipeline``, ``chunk_rows``, ``cache`` and ``nonfinite`` as
    :func:`sharded_score` (``chunk_rows`` rounds to the ``data`` axis; the
    first ``trees`` shard of a row block counts its NaN/inf values)."""
    check_nonfinite_policy(nonfinite)
    X, cache = _prepare(forest, X, cache)
    n = int(X.shape[0])
    d_data, d_trees = mesh.shape[DATA_AXIS], mesh.shape[TREES_AXIS]
    block, step = _row_plan(mesh, X, d_data, pipeline, chunk_rows)
    stream = step < block
    strategy = resolve_sharded_strategy(mesh, score_strategy, forest=forest, X=X, num_samples=num_samples,
                                        num_rows=max(step, 1), cache=cache)
    dev0 = mesh.first_device
    if n == 0:
        return torch.zeros(0, dtype=torch.float32, device=dev0)
    forest_p, _ = _pad_trees_neutral(forest, d_trees)
    slab = forest_p.num_trees // d_trees
    t_slab = torch.full((), float(slab), dtype=torch.float32, device=dev0)
    # each data row's partial sums, by the rows' block index
    partials: dict = {}
    counts: list = []
    rows_on: dict = {}  # a row block on a device, shared by the shards there (single-shot calls)
    for s in mesh.local_shards:
        i, j = divmod(s, d_trees)
        dev = mesh.flat_devices[s]
        # a slab's forest and tables live in a cache of their own, per device
        slab_cache = cache.setdefault(("trees_slab", d_trees, j), {})
        sub = slab_cache.get(("forest", dev))
        if sub is None:
            sub = slab_cache[("forest", dev)] = type(forest_p)(
                *(a[j * slab : (j + 1) * slab].to(dev) for a in forest_p))
        rows = rows_on.get((i, dev))
        if rows is None:
            rows = _rows_block(X, i, block)
            rows = rows_on[(i, dev)] = rows if stream else rows.to(dev)
        pl = mean_path_lengths(sub, rows, strategy, device=dev, cache=slab_cache,
                               chunk_rows=step, pipeline=pipeline,
                               site="sharded_2d", nonfinite=nonfinite if j == 0 else "allow",
                               nonfinite_counts=counts)
        partials.setdefault(i, []).append(pl.to(dev0) * t_slab)
    pad_rows = sum(block - max(0, min(block, n - i * block)) for i in {s // d_trees for s in mesh.local_shards
                                                                       if s % d_trees == 0})
    _report_non_finite(mesh, counts, X, pad_rows, nonfinite)
    t_true = torch.full((), float(forest.num_trees), dtype=torch.float32, device=dev0)
    blocks = torch.zeros((d_data, block), dtype=torch.float32, device=dev0)
    for i, parts in partials.items():
        group = mesh.row_groups.get(i)  # set where the row's shards span ranks
        total = reduce_local(parts, "sum", dev0) if group is None else reduce_shards(mesh, parts, "sum", group)
        # the rank holding the row's first shard contributes its block
        if mesh.owners[i, 0] == mesh.rank:
            blocks[i] = total / t_true
    if mesh.distributed:
        blocks = reduce_shards(mesh, [blocks], "sum")  # blocks other ranks lead are zeros here: exact
    return score_from_path_length(blocks.reshape(-1)[:n], num_samples)


__all__ = [
    "resolve_sharded_strategy",
    "sharded_grow_extended_forest",
    "sharded_grow_forest",
    "sharded_path_lengths",
    "sharded_score",
    "sharded_score_2d",
]
