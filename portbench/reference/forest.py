"""The benchmark's own forest growers, in NumPy, by the published algorithms.

* Standard (Liu, Ting and Zhou, ICDM 2008): each tree is grown from
  ``max_samples`` training rows drawn without replacement; a node splits on
  a feature drawn uniformly among those not constant on its rows, at a
  threshold uniform in the node's ``[min, max)`` of that feature, and stops
  at one row or at the height limit ``ceil(log2(max_samples))``.
* Extended (Hariri, Carrasco Kind and Brunner, arXiv:1811.02141): the split
  is a hyperplane with a normal direction drawn on ``extension_level + 1``
  coordinates chosen uniformly and an intercept point uniform in the node's
  bounding box; the side is ``dot(x, w) >= dot(p, w)``.

The trees are implicit heaps of ``2^(h+1) - 1`` slots (children of ``i`` at
``2i + 1`` and ``2i + 2``), as the port's forest arrays: ``-1`` marks a leaf
or hole in ``feature`` / ``indices[..., 0]``, and ``num_instances`` holds a
leaf's training rows, ``-1`` elsewhere. Rows with ``x >= threshold`` go
right. The forest is drawn from the seed on the host and handed as the same
arrays to the port and to the reference scorer.
"""

from __future__ import annotations

import math

import numpy as np


def height_limit(max_samples: int) -> int:
    return int(math.ceil(math.log2(max_samples))) if max_samples > 1 else 0


def _threshold(lo: np.float32, hi: np.float32, u: float) -> np.float32:
    """A float32 threshold in ``(lo, hi]``, so that both sides of the split
    keep at least one row (``x >= t`` goes right)."""
    t = np.float32(float(lo) + u * (float(hi) - float(lo)))
    if t <= lo:
        t = np.nextafter(lo, np.float32(np.inf))
    return min(t, hi)


def grow_standard(train: np.ndarray, *, num_trees: int, max_samples: int, rng: np.random.Generator) -> dict:
    """A standard forest over ``train`` (``f32[N, F]``): ``feature`` i32,
    ``threshold`` f32 and ``num_instances`` i32, each ``[T, M]``."""
    h = height_limit(max_samples)
    m = (1 << (h + 1)) - 1
    feature = np.full((num_trees, m), -1, np.int32)
    threshold = np.zeros((num_trees, m), np.float32)
    num_instances = np.full((num_trees, m), -1, np.int32)
    for t in range(num_trees):
        sample = train[rng.choice(train.shape[0], size=min(max_samples, train.shape[0]), replace=False)]
        stack = [(0, 0, sample)]
        while stack:
            slot, depth, rows = stack.pop()
            lo, hi = (rows.min(axis=0), rows.max(axis=0)) if len(rows) else (None, None)
            open_features = np.flatnonzero(hi > lo) if len(rows) > 1 else np.zeros(0, np.int64)
            if depth >= h or open_features.size == 0:
                num_instances[t, slot] = len(rows)
                continue
            f = int(open_features[rng.integers(open_features.size)])
            thr = _threshold(lo[f], hi[f], rng.random())
            feature[t, slot], threshold[t, slot] = f, thr
            right = rows[:, f] >= thr
            stack.append((2 * slot + 2, depth + 1, rows[right]))
            stack.append((2 * slot + 1, depth + 1, rows[~right]))
    return {"feature": feature, "threshold": threshold, "num_instances": num_instances}


def grow_extended(train: np.ndarray, *, num_trees: int, max_samples: int, extension_level: int,
                  rng: np.random.Generator) -> dict:
    """An extended forest over ``train``: ``indices`` i32 and ``weights``
    f32 ``[T, M, k]`` with ``k = extension_level + 1`` (the used coordinates,
    ascending), ``offset`` f32 and ``num_instances`` i32 ``[T, M]``."""
    n_features = train.shape[1]
    k = extension_level + 1
    if not 1 <= k <= n_features:
        raise ValueError(f"extension_level {extension_level} does not fit {n_features} features")
    h = height_limit(max_samples)
    m = (1 << (h + 1)) - 1
    indices = np.full((num_trees, m, k), -1, np.int32)
    weights = np.zeros((num_trees, m, k), np.float32)
    offset = np.zeros((num_trees, m), np.float32)
    num_instances = np.full((num_trees, m), -1, np.int32)
    for t in range(num_trees):
        sample = train[rng.choice(train.shape[0], size=min(max_samples, train.shape[0]), replace=False)]
        stack = [(0, 0, sample.astype(np.float64))]
        while stack:
            slot, depth, rows = stack.pop()
            if depth >= h or len(rows) <= 1 or not (rows.max(axis=0) > rows.min(axis=0)).any():
                num_instances[t, slot] = len(rows)
                continue
            coords = np.sort(rng.choice(n_features, size=k, replace=False)) if k < n_features else np.arange(k)
            w = rng.standard_normal(k).astype(np.float32)
            lo, hi = rows[:, coords].min(axis=0), rows[:, coords].max(axis=0)
            p = lo + rng.random(k) * (hi - lo)
            off = np.float32(np.dot(p, w.astype(np.float64)))
            indices[t, slot], weights[t, slot], offset[t, slot] = coords, w, off
            right = rows[:, coords] @ w.astype(np.float64) >= np.float64(off)
            stack.append((2 * slot + 2, depth + 1, rows[right]))
            stack.append((2 * slot + 1, depth + 1, rows[~right]))
    return {"indices": indices, "weights": weights, "offset": offset, "num_instances": num_instances}


def grow(forest: dict, train: np.ndarray, *, seed_rng: np.random.Generator) -> dict:
    """The forest of a configuration's ``forest`` block (``{"kind":
    "standard" | "extended", "num_trees", "max_samples"[,
    "extension_level"]}``) over ``train``."""
    common = {"num_trees": int(forest["num_trees"]), "max_samples": int(forest["max_samples"]), "rng": seed_rng}
    if forest["kind"] == "standard":
        return grow_standard(train, **common)
    if forest["kind"] == "extended":
        return grow_extended(train, extension_level=int(forest["extension_level"]), **common)
    raise ValueError(f"unknown forest kind {forest['kind']!r}")
