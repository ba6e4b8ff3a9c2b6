"""Seeded synthetic heap forests and rows, and growth's invariants, for the
port's tests and ``chip_smoke.py``.

numpy only: the arrays feed both :func:`isoforest_tpu_torch.io.interop.forest_from_arrays`
(or ``extended_forest_from_arrays``) and the JAX package's ``StandardForest``
(or ``ExtendedForest``), so the two packages walk the same forest; and
:func:`growth_invariant_errors` and :func:`extended_growth_invariant_errors`
check a forest either package grew.
"""

from __future__ import annotations

import contextlib

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


def random_extended_forest(
    rng,
    trees: int,
    height: int,
    features: int,
    k: int,
    split_p: float = 0.8,
    sizes=None,
    intercepts=None,
    unused_p: float = 0.0,
):
    """A valid extended heap forest ``(indices, weights, offset,
    num_instances)``: ``[trees, M, k]``, ``[trees, M, k]``, ``[trees, M]``
    and ``[trees, M]`` with ``M = 2^(height+1) - 1``. Tree 0 is a root
    leaf; the other roots split, each deeper node with probability
    ``split_p`` down to ``height``.

    Each internal node takes ``k`` distinct coordinates (``k <= features``)
    in ascending order, unit Gaussian weights, and the offset ``w . p``
    (float32 FMA chain, as growth's reduce) of an intercept point ``p``: a
    random row of ``intercepts`` when given, else a half-integer point in
    [-2, 2]. Rows equal to ``p`` on the node's coordinates then tie the
    offset exactly. With probability ``unused_p`` a node keeps only some
    of its coordinates and marks the rest unused (index -1, weight 0), as a
    loaded model's narrower nodes do. Leaf sizes are drawn from 0..299, or
    from ``sizes`` when given."""
    if not 1 <= k <= features:
        raise ValueError(f"need 1 <= k <= features, got k={k}, features={features}")
    m = 2 ** (height + 1) - 1
    indices = np.full((trees, m, k), -1, np.int32)
    weights = np.zeros((trees, m, k), np.float32)
    points = np.zeros((trees, m, k), np.float32)
    num_instances = np.full((trees, m), -1, np.int32)
    for t in range(trees):
        stack = [(0, 0)]
        while stack:
            slot, depth = stack.pop()
            if t > 0 and depth < height and (slot == 0 or rng.random() < split_p):
                used = k if rng.random() >= unused_p else int(rng.integers(1, k + 1))
                coords = np.sort(rng.choice(features, size=used, replace=False)).astype(np.int32)
                w = rng.normal(size=used).astype(np.float32)
                w = (w / np.float32(np.sqrt(np.sum(w * w, dtype=np.float32)))).astype(np.float32)
                if intercepts is None:
                    point = (rng.integers(-4, 5, size=features) / 2).astype(np.float32)
                else:
                    point = np.asarray(intercepts, np.float32)[rng.integers(len(intercepts))]
                indices[t, slot, :used] = coords
                weights[t, slot, :used] = w
                points[t, slot, :used] = point[coords]
                stack += [(2 * slot + 1, depth + 1), (2 * slot + 2, depth + 1)]
            else:
                num_instances[t, slot] = rng.integers(0, 300) if sizes is None else rng.choice(sizes)
    offset = np.zeros((trees, m), np.float32)
    for q in range(k):  # d = fma(p_q, w_q, d), each step through float64
        offset = (points[..., q].astype(np.float64) * weights[..., q] + offset).astype(np.float32)
    return indices, weights, offset, num_instances


def growth_invariant_errors(feature, threshold, num_instances, X, num_samples, allowed_features=None) -> list:
    """What a grown standard forest breaks of growth's invariants (none: an
    empty list), checked on numpy copies: heap structure (disjoint roles,
    the root exists, an internal slot has both children, a leaf or hole
    none), leaf counts summing to ``num_samples`` per tree, no constant
    feature of ``X`` chosen, every threshold within its feature's range in
    ``X``, and each tree's features within ``allowed_features[t]`` when
    given (its feature subset)."""
    feature, threshold, num_instances, X = (np.asarray(a) for a in (feature, threshold, num_instances, X))
    internal, leaf = feature >= 0, num_instances >= 0
    errors = _heap_errors(internal, leaf, num_instances, num_samples)
    lo, hi = X.min(axis=0), X.max(axis=0)
    chosen = np.unique(feature[internal])
    constant = chosen[lo[chosen] == hi[chosen]]
    if constant.size:
        errors.append(f"constant features chosen: {constant.tolist()}")
    f = feature.clip(min=0)
    if np.any(internal & ((threshold < lo[f]) | (threshold > hi[f]))):
        errors.append("a threshold lies outside its feature's range")
    if allowed_features is not None:
        allowed = np.asarray(allowed_features)
        for t in range(feature.shape[0]):
            if not np.isin(feature[t][internal[t]], allowed[t]).all():
                errors.append(f"tree {t} splits outside its feature subset")
                break
    return errors


def _heap_errors(internal, leaf, num_instances, num_samples) -> list:
    """Heap structure (disjoint roles, the root exists, an internal slot has
    both children, a leaf or hole none) and leaf counts summing to
    ``num_samples`` per tree."""
    errors = []
    exists = internal | leaf
    m = internal.shape[1]
    if np.any(internal & leaf):
        errors.append("a slot is both internal and a leaf")
    if not np.all(exists[:, 0]):
        errors.append("a tree has no root")
    parents = np.arange((m - 1) // 2)
    kids = np.stack([exists[:, 2 * parents + 1], exists[:, 2 * parents + 2]])
    if np.any(internal[:, parents] & ~kids.all(axis=0)):
        errors.append("an internal slot lacks a child")
    if np.any(~internal[:, parents] & kids.any(axis=0)):
        errors.append("a leaf or hole has a child")
    sums = np.where(leaf, num_instances, 0).sum(axis=1)
    if not np.all(sums == num_samples):
        errors.append(f"leaf counts sum to {sorted(set(sums.tolist()))}, not {num_samples}")
    return errors


def extended_growth_invariant_errors(indices, weights, offset, num_instances, X, num_samples,
                                     allowed_features=None) -> list:
    """What a grown EIF forest breaks of growth's invariants (none: an empty
    list), on numpy copies: heap structure and leaf counts as for the
    standard forest, unit-norm weights at internal slots, strictly
    ascending coordinates within ``X``'s width, finite offsets, and each
    tree's coordinates within ``allowed_features[t]`` when given."""
    indices, weights, offset, num_instances = (np.asarray(a) for a in (indices, weights, offset, num_instances))
    internal, leaf = indices[..., 0] >= 0, num_instances >= 0
    errors = _heap_errors(internal, leaf, num_instances, num_samples)
    sub = indices[internal]
    norms = np.linalg.norm(weights[internal].astype(np.float64), axis=-1)
    if not np.allclose(norms, 1.0, atol=1e-5):
        errors.append("a hyperplane's weights are not of unit norm")
    if sub.size and (sub.min() < 0 or sub.max() >= np.asarray(X).shape[1]):
        errors.append("a coordinate lies outside the data's width")
    if sub.shape[-1] > 1 and not np.all(np.diff(sub, axis=1) > 0):
        errors.append("a hyperplane's coordinates are not strictly ascending")
    if not np.all(np.isfinite(offset[internal])):
        errors.append("a non-finite offset")
    if allowed_features is not None:
        allowed = np.asarray(allowed_features)
        for t in range(indices.shape[0]):
            if not np.isin(indices[t][internal[t]], allowed[t]).all():
                errors.append(f"tree {t} splits outside its feature subset")
                break
    return errors


@contextlib.contextmanager
def torch_threads(n: int):
    """Run the block with ``n`` torch intra-op threads, then restore the
    count. Tests that run many float64 elementwise ops side by side with
    other test processes take one thread each: a thread pool per process
    oversubscribes the cores, and its threads spin waiting for each other."""
    import torch

    previous = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(previous)
