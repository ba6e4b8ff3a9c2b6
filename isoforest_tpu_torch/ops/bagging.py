"""Per-tree bags and feature subsets (``isoforest_tpu/ops/bagging.py``).

Every tree receives ``numSamples`` rows drawn uniformly, with replacement
iff ``bootstrap``, and a sorted random subset of ``numFeatures`` features
(BaggedPoint.scala:114-217, SharedTrainLogic.scala:99-153, 300-304). The
draws are the JAX package's, bit for bit: the same threefry keys
(:mod:`.prng`), the same dispatch between samplers, and the same samplers.
Everything is drawn on the device of the key, for all trees in one call.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import prng

# Dispatch thresholds (bagging.py:32, :36): the full per-tree permutation
# is used while T * N stays below this many elements...
PERMUTATION_MAX_ELEMS = 1 << 26
# ...and Floyd's O(S^2) sampler up to this bag size; the top-k sampler above.
FLOYD_MAX_SAMPLES = 1 << 12


def per_tree_keys(key: torch.Tensor, num_trees: int) -> torch.Tensor:
    """``fold_in(key, tree_id)`` for every tree: ``[num_trees, 2]``."""
    return prng.fold_in(key, torch.arange(num_trees, device=key.device))


def _floyd_sample(tree_keys: torch.Tensor, num_rows: int, num_samples: int) -> torch.Tensor:
    """Floyd's exact uniform ``num_samples``-subset of ``[0, num_rows)`` per
    tree: for ``j = N-S .. N-1`` draw ``t ~ U[0, j]``, keep ``t`` unless
    already drawn, else keep ``j``. The draws ``randint(fold_in(key, i), 0,
    j + 1)`` do not depend on the buffer, so all are drawn in one call; only
    the O(S) dedup runs step by step."""
    dev = tree_keys.device
    i = torch.arange(num_samples, device=dev)
    j = num_rows - num_samples + i
    draws = prng.randint(prng.fold_in(tree_keys[:, None, :], i), (), 0, j + 1)  # [T, S]
    buf = torch.full_like(draws, -1)
    for step in range(num_samples):
        t = draws[:, step]
        seen = (buf[:, :step] == t[:, None]).any(dim=1)
        buf[:, step] = torch.where(seen, j[step].to(torch.int32), t)
    return buf


def _topk_sample(tree_keys: torch.Tensor, num_rows: int, num_samples: int) -> torch.Tensor:
    """Exact uniform subsets for large bags: rank each tree's rows by a
    64-bit random key (two words, compared lexicographically by a stable
    sort) and keep the ``num_samples`` highest. Trees go in chunks so the
    ``[chunk, N]`` transient stays bounded; chunking does not change a draw."""
    num_trees = tree_keys.shape[0]
    chunk = max(1, min(num_trees, PERMUTATION_MAX_ELEMS // max(num_rows, 1)))
    parts = []
    for t0 in range(0, num_trees, chunk):
        k = prng.split(tree_keys[t0 : t0 + chunk])
        r1 = prng.bits(k[:, 0, :], (num_rows,))
        r2 = prng.bits(k[:, 1, :], (num_rows,))
        # (r1, r2) as one signed 64-bit key with the same order
        key64 = ((r1 - (1 << 31)) << 32) + r2
        order = torch.sort(key64, dim=1, stable=True).indices
        parts.append(order[:, num_rows - num_samples :].to(torch.int32))
    return torch.cat(parts)


def _bagged_indices(key, num_rows, num_samples, num_trees, bootstrap, perm_max, floyd_max):
    """The sampler dispatch of ``_bagged_indices_jit`` (bagging.py:111-134);
    the thresholds come in as arguments so tests can reach every branch."""
    tree_keys = per_tree_keys(key, num_trees)
    if bootstrap:
        return prng.randint(tree_keys, (num_samples,), 0, num_rows)
    if num_samples <= floyd_max and num_samples * num_samples <= 200 * num_rows:
        return _floyd_sample(tree_keys, num_rows, num_samples)
    if num_rows * num_trees <= perm_max:
        return prng.permutation(tree_keys, num_rows)[:, :num_samples].to(torch.int32)
    if num_samples <= floyd_max:
        return _floyd_sample(tree_keys, num_rows, num_samples)
    return _topk_sample(tree_keys, num_rows, num_samples)


def bagged_indices(
    key: torch.Tensor,
    num_rows: int,
    num_samples: int,
    num_trees: int,
    bootstrap: bool,
) -> torch.Tensor:
    """``int32 [num_trees, num_samples]`` row indices, one bag per tree, on
    the key's device. Without ``bootstrap`` the rows of a bag are distinct,
    so a bag larger than the data is refused."""
    if not bootstrap and num_samples > num_rows:
        raise ValueError(
            f"cannot draw {num_samples} distinct rows from {num_rows} without "
            "replacement (bootstrap=False)"
        )
    return _bagged_indices(
        key, num_rows, num_samples, num_trees, bootstrap, PERMUTATION_MAX_ELEMS, FLOYD_MAX_SAMPLES
    )


def feature_subsets(
    key: torch.Tensor, total_num_features: int, num_features: int, num_trees: int
) -> torch.Tensor:
    """Per-tree sorted random feature subsets, ``int32 [num_trees,
    num_features]``: ``shuffle(0..F-1).take(numFeatures).sorted``
    (SharedTrainLogic.scala:300-304)."""
    perm = prng.permutation(per_tree_keys(key, num_trees), total_num_features)
    return torch.sort(perm[:, :num_features], dim=1).values.to(torch.int32)


def ensemble_draws(
    key: torch.Tensor,
    X: torch.Tensor,
    *,
    num_samples: int,
    num_trees: int,
    bootstrap: bool,
    num_features: int,
    bag: Optional[torch.Tensor] = None,
):
    """Every draw of a fit's ensemble from its key, in the JAX package's
    order: ``(k_bag, k_feat, k_grow) = split(key, 3)``, then the bags
    (``bag``, when given, replaces them: a fit from a sample), the feature
    subsets and the per-tree keys, as ``(tree_keys, bag, feat_idx)``.

    A checkpointed fit slices these per block rather than drawing per
    block, since the samplers' dispatch depends on the tree count; so the
    plain fit and the checkpointed one grow the same trees.
    """
    num_rows, num_features_total = int(X.shape[0]), int(X.shape[1])
    k_bag, k_feat, k_grow = prng.split(key, 3)
    if bag is None:
        bag = bagged_indices(k_bag, num_rows, num_samples, num_trees, bootstrap)
    feat_idx = feature_subsets(k_feat, num_features_total, num_features, num_trees)
    return per_tree_keys(k_grow, num_trees), bag, feat_idx


def gather_tree_data(X: torch.Tensor, bag_idx: torch.Tensor, feat_idx: torch.Tensor) -> torch.Tensor:
    """Per-tree training slabs ``f32 [T, S, num_features]``: the bag's rows,
    the tree's features."""
    rows = X[bag_idx.long()]  # [T, S, F]
    return rows.gather(2, feat_idx.long()[:, None, :].expand(-1, rows.shape[1], -1))
