"""Forest structure diagnostics (``isoforest_tpu/telemetry/diagnostics.py``).

``model.diagnostics()`` answers what the scores cannot: how deep the
trees grew, how large their leaves are, which features they split on, and
how far the realised average path length sits from the ``c(n)`` the score
normalisation assumes. The JAX package reads its packed scoring layout;
the port computes the same quantities from its forest tensors and the leaf
table ``depth + c(numInstances)`` (:func:`~..utils.math.leaf_value_table`),
copied to the host once. The instance-weighted mean of that table over a
tree's leaves is the expected path length of a training point through the
tree. :func:`publish_gauges` mirrors the result onto ``isoforest_forest_*``
gauges.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .metrics import gauge as _gauge

_FOREST_TREES = _gauge("isoforest_forest_trees", "Trees in the diagnosed forest")
_FOREST_TREE_DEPTH = _gauge(
    "isoforest_forest_tree_depth", "Per-tree max leaf depth of the diagnosed forest, by aggregate stat",
    labelnames=("stat",),
)
_FOREST_LEAF_SIZE = _gauge(
    "isoforest_forest_leaf_size", "Leaf numInstances of the diagnosed forest, by aggregate stat",
    labelnames=("stat",),
)
_FOREST_AVG_PATH_LENGTH = _gauge(
    "isoforest_forest_avg_path_length",
    "Expected c(numSamples) vs realised instance-weighted average path length of the diagnosed forest",
    labelnames=("kind",),
)
_FOREST_SPLIT_USAGE = _gauge(
    "isoforest_forest_feature_split_usage", "Internal-node split count per feature id in the diagnosed forest",
    labelnames=("feature",),
)


def forest_diagnostics(model) -> dict:
    """Structure diagnostics of a fitted or loaded model, in plain JSON types.

    Keys: ``model``/``num_trees``/``max_nodes``/``num_samples``/
    ``height_limit``, ``nodes`` (internal/leaf/slot counts, occupancy),
    ``tree_depth`` (per-tree max leaf depth: min/max/mean, histogram),
    ``leaf_size`` (min/max/mean, power-of-two histogram), ``leaf_depth``
    (instance-weighted mean/std), ``feature_split_usage`` (feature id ->
    internal splits; an EIF counts every hyperplane coordinate),
    ``path_length`` (expected ``c(n)`` against the realised weighted mean,
    per-tree min/max, ratio) and ``imbalance``.
    """
    from ..ops.ext_growth import ExtendedForest
    from ..utils.math import avg_path_length, height_of, leaf_value_table

    forest = model.forest
    ni = forest.num_instances.cpu().numpy()
    num_trees, max_nodes = ni.shape
    height = height_of(max_nodes)
    leaf = ni >= 0
    standard = not isinstance(forest, ExtendedForest)
    if standard:
        feat = forest.feature.cpu().numpy().astype(np.int64)
        internal = feat >= 0
        usage = np.bincount(feat[internal]) if internal.any() else np.zeros(0, np.int64)
    else:
        ids = forest.indices.cpu().numpy().astype(np.int64)
        internal = ids[..., 0] >= 0
        used = ids[internal].reshape(-1)
        used = used[used >= 0]
        usage = np.bincount(used) if used.size else np.zeros(0, np.int64)

    depths = np.concatenate([np.full((1 << lv,), float(lv), np.float32) for lv in range(height + 1)])
    value = leaf_value_table(forest.num_instances, height).numpy().astype(np.float64)  # depth + c(n) at leaves

    # per tree the leaf weights sum to the bag size, so the weighted mean
    # of the leaf table is a training point's realised path length
    w = np.where(leaf, ni, 0).astype(np.float64)
    wsum = np.maximum(w.sum(axis=1), 1.0)
    actual_pl = (w * np.where(leaf, value, 0.0)).sum(axis=1) / wsum
    d = np.broadcast_to(depths, (num_trees, max_nodes)).astype(np.float64)
    mean_leaf_depth = (w * np.where(leaf, d, 0.0)).sum(axis=1) / wsum
    mean_leaf_depth_sq = (w * np.where(leaf, d, 0.0) ** 2).sum(axis=1) / wsum
    leaf_depth_std = np.sqrt(np.maximum(mean_leaf_depth_sq - mean_leaf_depth**2, 0.0))

    tree_depth_max = np.where(leaf, d, -np.inf).max(axis=1)
    tree_depth_min = np.where(leaf, d, np.inf).min(axis=1)
    depth_hist: Dict[str, int] = {}
    for depth_value in tree_depth_max:
        key = str(int(depth_value))
        depth_hist[key] = depth_hist.get(key, 0) + 1

    sizes = ni[leaf].astype(np.int64)
    size_bucket = np.floor(np.log2(np.maximum(sizes, 1))).astype(np.int64)
    size_hist = {
        f"{1 << int(b)}-{(1 << (int(b) + 1)) - 1}": int(c) for b, c in zip(*np.unique(size_bucket, return_counts=True))
    }

    expected = float(avg_path_length(model.num_samples))
    internal_count = int(internal.sum())
    leaf_count = int(leaf.sum())
    return {
        "model": "standard" if standard else "extended",
        "num_trees": int(num_trees),
        "max_nodes": int(max_nodes),
        "num_samples": int(model.num_samples),
        "height_limit": int(height),
        "nodes": {
            "internal": internal_count,
            "leaves": leaf_count,
            "slots": int(num_trees * max_nodes),
            "occupancy": round((internal_count + leaf_count) / float(num_trees * max_nodes), 6),
        },
        "tree_depth": {
            "min": int(tree_depth_max.min()),
            "max": int(tree_depth_max.max()),
            "mean": round(float(tree_depth_max.mean()), 4),
            "histogram": {k: depth_hist[k] for k in sorted(depth_hist, key=int)},
        },
        "leaf_depth": {
            "weighted_mean": round(float(mean_leaf_depth.mean()), 4),
            "weighted_std": round(float(leaf_depth_std.mean()), 4),
        },
        "leaf_size": {
            "min": int(sizes.min()),
            "max": int(sizes.max()),
            "mean": round(float(sizes.mean()), 4),
            "histogram": size_hist,
        },
        "feature_split_usage": {str(i): int(c) for i, c in enumerate(usage) if c},
        "path_length": {
            "expected": round(expected, 6),
            "actual_mean": round(float(actual_pl.mean()), 6),
            "actual_min": round(float(actual_pl.min()), 6),
            "actual_max": round(float(actual_pl.max()), 6),
            "ratio_actual_to_expected": round(float(actual_pl.mean()) / expected, 6) if expected > 0 else None,
        },
        "imbalance": {
            "depth_spread_mean": round(float((tree_depth_max - tree_depth_min).mean()), 4),
            "leaf_depth_std_mean": round(float(leaf_depth_std.mean()), 4),
            "height_utilisation": round(float(tree_depth_max.mean()) / height, 4) if height > 0 else None,
        },
    }


def publish_gauges(diag: dict) -> None:
    """Mirror a :func:`forest_diagnostics` result onto the
    ``isoforest_forest_*`` gauges of the metrics registry."""
    _FOREST_TREES.set(diag["num_trees"])
    for stat in ("min", "max", "mean"):
        _FOREST_TREE_DEPTH.set(diag["tree_depth"][stat], stat=stat)
        _FOREST_LEAF_SIZE.set(diag["leaf_size"][stat], stat=stat)
    _FOREST_AVG_PATH_LENGTH.set(diag["path_length"]["expected"], kind="expected")
    _FOREST_AVG_PATH_LENGTH.set(diag["path_length"]["actual_mean"], kind="actual")
    for feature, count in diag["feature_split_usage"].items():
        _FOREST_SPLIT_USAGE.set(count, feature=feature)
