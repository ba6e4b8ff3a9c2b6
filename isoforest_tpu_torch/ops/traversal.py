"""Scoring a matrix of rows (``isoforest_tpu/ops/traversal.py``).

:func:`score_matrix` validates the width, chunks the rows and sends each
chunk through one kernel, chosen by the forest's type and the strategy:

* standard forest: ``"walk"`` (O(h) node-id walk, :mod:`.walk`) or
  ``"dense"`` (gather-free level walk, :mod:`.dense`);
* extended forest: ``"walk"`` (:mod:`.ext_walk`, any k) or ``"dense"``
  (:mod:`.ext_dense`: the sparse kernel for k <= 32, the dense-table kernel
  above).

``"auto"`` resolves to ``"walk"`` for both: it beat the dense kernels at
every batch size measured on the card (PERF.md).

:func:`standard_path_lengths` and :func:`extended_path_lengths` are the
gather walks of the JAX package (``_walk_blocks`` + ``_walk_one_standard``
/ ``_walk_one_extended``): references for the tests, not strategies.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..utils.device import resolve_device
from ..utils.math import fma_f32, score_from_path_length
from ..utils.validation import extract_features, validate_feature_vector_size
from . import dense, ext_dense, ext_walk, walk
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

# Rows per kernel launch: bounds the device memory of one chunk's input and
# output (24 MB of X at F=6) while the 1M-row headline stays one launch.
DEFAULT_CHUNK_ROWS = 1 << 20

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


def _resolve_strategy(strategy: str) -> str:
    if strategy == "auto":
        return "walk"
    if strategy not in STRATEGIES:
        raise ValueError(
            f"unknown scoring strategy {strategy!r}; expected 'auto', "
            + ", ".join(repr(s) for s in STRATEGIES)
        )
    return strategy


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
) -> torch.Tensor:
    """Outlier scores ``2^(-E[h]/c(num_samples))`` of an ``[N, F]`` matrix, ``f32[N]``.

    ``forest``: a :class:`StandardForest` or an :class:`ExtendedForest`.
    ``X`` (tensor, array or DataFrame) is converted, checked and moved to
    ``device`` by :func:`~isoforest_tpu_torch.utils.validation.extract_features`
    (default: the card; the forest is moved there too). ``strategy``: ``"walk"``, ``"dense"``
    (trees up to height ``dense.DENSE_MAX_HEIGHT``) or ``"auto"``.
    ``expected_features`` (the model's training width) makes a wrong-width
    ``X`` a ValueError; a matrix narrower than the forest's highest split
    feature is always refused. ``cache``: a dict the caller keeps per forest,
    holding the kernel tables and the width floor between calls.
    ``nonfinite``: NaN/inf policy (``"warn"``/``"raise"``/``"allow"``).
    """
    dev = resolve_device(device)
    strategy = _resolve_strategy(strategy)
    X, _ = extract_features(X, nonfinite=nonfinite, device=dev)
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
    build, run = (_EXT_KERNELS if isinstance(forest, ExtendedForest) else _KERNELS)[strategy]
    tables = cache.get((strategy, dev))
    if tables is None:
        tables = cache[(strategy, dev)] = build(forest)
    chunk = chunk_size or DEFAULT_CHUNK_ROWS
    # chunks bound each launch; the scores take one pass, so chunking stays
    # bitwise neutral even where exp2 rounds differently by vector position
    parts = [run(X[i : i + chunk], tables) for i in range(0, X.shape[0], chunk)]
    path_lengths = torch.cat(parts) if parts else torch.zeros(0, dtype=torch.float32, device=dev)
    return score_from_path_length(path_lengths, num_samples)
