"""Seeded synthetic heap forests and rows, for the port's tests and ``chip_smoke.py``.

numpy only: the arrays feed both :func:`isoforest_tpu_torch.io.interop.forest_from_arrays`
and the JAX package's ``StandardForest``, so the two packages walk the same forest.
"""

from __future__ import annotations

import numpy as np


def random_heap_forest(rng, trees: int, height: int, features: int, split_p: float = 0.8, sizes=None):
    """A valid heap forest ``(feature, threshold, num_instances)``, each
    ``[trees, 2^(height+1) - 1]``: every internal slot has both children,
    tree 0 is a root leaf, and the other roots split, each deeper node with
    probability ``split_p`` down to ``height``. Thresholds are half-integers
    in [-2, 2], so :func:`rows` ties them; leaf sizes are drawn from 0..299,
    or from ``sizes`` when given."""
    m = 2 ** (height + 1) - 1
    feature = np.full((trees, m), -1, np.int32)
    threshold = np.zeros((trees, m), np.float32)
    num_instances = np.full((trees, m), -1, np.int32)
    for t in range(trees):
        stack = [(0, 0)]
        while stack:
            slot, depth = stack.pop()
            if t > 0 and depth < height and (slot == 0 or rng.random() < split_p):
                feature[t, slot] = rng.integers(features)
                threshold[t, slot] = np.float32(rng.integers(-4, 5) / 2)
                stack += [(2 * slot + 1, depth + 1), (2 * slot + 2, depth + 1)]
            else:
                num_instances[t, slot] = rng.integers(0, 300) if sizes is None else rng.choice(sizes)
    return feature, threshold, num_instances


def finite_rows(rng, n: int, features: int) -> np.ndarray:
    """Half-integer rows in [-2.5, 2.5], ``f32[n, features]``."""
    return (rng.integers(-5, 6, size=(n, features)) / 2).astype(np.float32)


def rows(rng, n: int, features: int) -> np.ndarray:
    """:func:`finite_rows` with NaN, +inf and -inf entries."""
    X = finite_rows(rng, n, features)
    X[::7, 0] = np.nan
    X[1::11, features - 1] = np.inf
    X[2::13, features // 2] = -np.inf
    return X
