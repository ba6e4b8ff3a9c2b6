"""The standard forest and its level-synchronous growth
(``isoforest_tpu/ops/tree_growth.py``).

A forest is a struct of arrays over ``[num_trees, max_nodes]`` implicit-heap
slots; children of slot ``i`` live at ``2i+1`` / ``2i+2``. Growth runs all
trees at once, level by level: at level ``l`` every sample of every tree
scatters its features into per-(tree, node) min/max statistics, every
level-``l`` node draws its split, and every sample routes one step down
(IsolationTree.scala:83-183):

* the split feature is uniform among the node's non-constant features, a
  Gumbel-argmax streamed over 64-feature chunks (:mod:`.level_window`);
* a node stops when no feature is splittable, at the height limit, or at
  one sample;
* the threshold is uniform in ``[min, max)`` of the node's data, computed as
  ``fma(u, max - min, min)``, the single rounding XLA:CPU gives the JAX
  package's ``min + u * (max - min)``; rows with ``x >= threshold`` go right.

The random stream is the JAX package's (:mod:`.prng`): per tree
``fold_in(k_grow, tree)``, per level ``split(key, h + 1)[l]``, then
``k_feat, k_thr = split(level_key)``, Gumbel draws per chunk from
``fold_in(k_feat, chunk)`` and thresholds from ``uniform(k_thr)``. Every
tensor stays on the data's device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.math import fma_f32, height_of
from . import level_window as lw
from . import prng
from .bagging import gather_tree_data


class StandardForest(NamedTuple):
    """``feature``: int32 split feature id, ``-1`` at leaves and holes.
    ``threshold``: float32 split value (the reference keeps a Double).
    ``num_instances``: int32 leaf size, ``-1`` at internal slots and holes
    (the Avro sentinels, IsolationForestModelReadWrite.scala:36-67)."""

    feature: torch.Tensor  # i32 [T, M]
    threshold: torch.Tensor  # f32 [T, M]
    num_instances: torch.Tensor  # i32 [T, M]

    @property
    def num_trees(self) -> int:
        return self.feature.shape[0]

    @property
    def max_nodes(self) -> int:
        return self.feature.shape[1]

    @property
    def height(self) -> int:
        return height_of(self.max_nodes)

    @property
    def device(self) -> torch.device:
        return self.feature.device

    def to(self, device) -> "StandardForest":
        return StandardForest(*(a.to(device) for a in self))


def _level_draws(level_key: torch.Tensor, l: int, w: int, fc: int, n_chunks: int):
    """One level's random draws for every tree: a function of the chunk
    ``c`` that draws its Gumbel values ``f32 [T, W, Fc]`` from ``fold_in(k_feat,
    c)`` when the chunk loop reaches it, so a level holds one chunk's draws
    at a time (the chunks' keys are folded in at once), and the threshold
    uniforms ``f32 [T, W]``. ``l`` is unused here; a test that replaces this
    function to feed the JAX package's own draws reads it."""
    k = prng.split(level_key)
    k_feat, k_thr = k[:, 0, :], k[:, 1, :]
    chunk_keys = prng.fold_in(k_feat[:, None, :], torch.arange(n_chunks, device=level_key.device))

    def chunk_gumbel(c: int) -> torch.Tensor:
        return prng.gumbel(chunk_keys[:, c], (w, fc))

    return chunk_gumbel, prng.uniform(k_thr, (w,))


def _scatter(init: float, idx: torch.Tensor, src: torch.Tensor, w: int, reduce: str) -> torch.Tensor:
    """Per-(tree, window row) reduction of ``src [T, S, Fc]`` over the
    samples of each row; the sentinel row ``W`` (settled samples) is dropped."""
    t, s, fc = src.shape
    out = torch.full((t, w + 1, fc), init, dtype=src.dtype, device=src.device)
    out.scatter_reduce_(1, idx[:, :, None].expand(t, s, fc), src, reduce, include_self=True)
    return out[:, :w]


def _grow_trees(tree_keys: torch.Tensor, x: torch.Tensor, h: int):
    """Grow one tree per key over ``x: f32 [T, S, F]`` (each tree's own
    rows and features); returns local-feature-indexed heap tables."""
    num_trees, num_samples, _ = x.shape
    dev = x.device
    m, w = 2 ** (h + 1) - 1, 2**h
    geom = lw.chunk_features(x)
    x, fc = geom.x, geom.chunk
    level_keys = prng.split(tree_keys, h + 1)  # [T, h + 1, 2]

    node_id = torch.zeros((num_trees, num_samples), dtype=torch.int64, device=dev)
    settled = torch.zeros((num_trees, num_samples), dtype=torch.bool, device=dev)
    feature = torch.full((num_trees, m), -1, dtype=torch.int32, device=dev)
    threshold = torch.zeros((num_trees, m), dtype=torch.float32, device=dev)
    num_instances = torch.full((num_trees, m), -1, dtype=torch.int32, device=dev)
    exists = torch.zeros((num_trees, m), dtype=torch.bool, device=dev)
    exists[:, 0] = True
    inf = float("inf")

    for l in range(h + 1):
        chunk_gumbel, u = _level_draws(level_keys[:, l], l, w, fc, geom.n_chunks)
        win = lw.level_window(l, w, node_id, settled)
        idx = win.idx_of_sample
        cnt = torch.zeros((num_trees, w + 1), dtype=torch.int32, device=dev)
        cnt.scatter_add_(1, idx, torch.ones_like(idx, dtype=torch.int32))
        cnt = cnt[:, :w]

        # the uniform choice among non-constant features as a Gumbel-argmax,
        # kept running across chunks (IsolationTree.scala:124-156)
        best_g = torch.full((num_trees, w), -inf, dtype=torch.float32, device=dev)
        best_f = torch.zeros((num_trees, w), dtype=torch.int64, device=dev)
        best_mn = torch.zeros((num_trees, w), dtype=torch.float32, device=dev)
        best_mx = torch.zeros((num_trees, w), dtype=torch.float32, device=dev)
        any_nc = torch.zeros((num_trees, w), dtype=torch.bool, device=dev)
        for c in range(geom.n_chunks):
            xc = x[:, :, c * fc : (c + 1) * fc]
            mn_c = _scatter(inf, idx, xc, w, "amin")
            mx_c = _scatter(-inf, idx, xc, w, "amax")
            nc = mn_c < mx_c
            g = torch.where(nc, chunk_gumbel(c), -inf)
            fj = torch.argmax(g, dim=2, keepdim=True)
            gj = g.gather(2, fj)[..., 0]
            upd = gj > best_g
            best_g = torch.where(upd, gj, best_g)
            best_f = torch.where(upd, c * fc + fj[..., 0], best_f)
            best_mn = torch.where(upd, mn_c.gather(2, fj)[..., 0], best_mn)
            best_mx = torch.where(upd, mx_c.gather(2, fj)[..., 0], best_mx)
            any_nc = any_nc | nc.any(dim=2)

        # split decision per level-l node (IsolationTree.scala:124-156)
        exists_w = exists[:, win.start : win.start + w]
        can_split = exists_w & win.in_level & (cnt > 1) & any_nc & (l < h)
        thr_w = fma_f32(u, best_mx - best_mn, best_mn)
        new_leaf = exists_w & win.in_level & ~can_split
        lw.patch(feature, best_f, can_split, win.start)
        lw.patch(threshold, thr_w, can_split, win.start)
        lw.patch(num_instances, cnt, new_leaf, win.start)
        lw.spawn_children(exists, can_split, win)

        # route unsettled samples one level down (x < t left, x >= t right)
        j_s = (node_id - win.start).clamp(0, w - 1)
        split_here = can_split.gather(1, j_s) & ~settled
        x_f = x.gather(2, best_f.gather(1, j_s)[:, :, None])[..., 0]
        go_right = x_f >= thr_w.gather(1, j_s)
        node_id = torch.where(split_here, 2 * node_id + 1 + go_right.long(), node_id)
        settled = settled | ~split_here

    return feature, threshold, num_instances


def grow_forest(
    tree_keys: torch.Tensor,
    X: torch.Tensor,
    bag_idx: torch.Tensor,
    feat_idx: torch.Tensor,
    height: int,
) -> StandardForest:
    """Grow ``T`` standard isolation trees, all at once.

    ``tree_keys``: per-tree keys ``[T, 2]`` (:func:`.bagging.per_tree_keys`);
    ``X``: f32 ``[N, F_total]``; ``bag_idx``: i32 ``[T, S]``; ``feat_idx``:
    i32 ``[T, F_sub]`` sorted global feature ids. Local split indices are
    mapped back to global feature ids, as the reference persists them.
    """
    x_trees = gather_tree_data(X, bag_idx, feat_idx)
    feature_local, threshold, num_instances = _grow_trees(tree_keys, x_trees, height)
    feature = torch.where(
        feature_local >= 0,
        feat_idx.gather(1, feature_local.clamp(min=0).long()),
        torch.tensor(-1, dtype=torch.int32, device=X.device),
    ).to(torch.int32)
    return StandardForest(feature=feature, threshold=threshold, num_instances=num_instances)
