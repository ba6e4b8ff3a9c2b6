"""The extended (EIF) forest and its level-synchronous growth
(``isoforest_tpu/ops/ext_growth.py``).

Each internal node holds a sparse hyperplane: ``k`` coordinates and their
weights, and the offset; rows with ``dot(x, w) < offset`` go left
(ExtendedIsolationTree.scala:230-232). Growth runs all trees at once, level
by level, on the heap layout of :mod:`.tree_growth`. At level ``l`` each
node:

* picks ``k = min(extensionLevel + 1, F)`` distinct coordinates, uniformly,
  as a running Gumbel top-k over 64-feature chunks (padded columns draw
  ``-inf``), sorted ascending (ExtendedIsolationTree.scala:157-160, 220-226);
* takes the min and max of its samples at those coordinates only;
* draws normal weights, normalised by ``max(norm, 1e-37)`` (a zero norm
  makes the node a leaf), and an intercept ``p = fma(u, max - min, min)``
  per coordinate, ``offset = sum(w * p)`` (:155-217);
* splits while it has more than one sample and is above the height limit;
  there is no retry: an empty side becomes a ``numInstances = 0`` leaf
  (ExtendedNodes.scala:32-35).

The random stream is the JAX package's (:mod:`.prng`): per tree
``split(key, h + 1)[l]``, then ``k_sub, k_w, k_p = split(level_key, 3)``,
Gumbel draws per chunk from ``fold_in(k_sub, chunk)``, weights from
``normal(k_w)``, intercepts from ``uniform(k_p)``; ``normal`` is jax's bit
for bit, and the Gumbel draws within an ulp (torch's ``log``). The three
sums over ``k`` (the norm, the offset and the routing dot) follow XLA:CPU's
order for the JAX package's program (:func:`row_dot`), so a row that ties
the offset routes as it does there. Every tensor stays on the data's device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.math import fma_f32, height_of
from . import level_window as lw
from . import prng
from .bagging import gather_tree_data
from .tree_growth import _scatter

# ``w / max(norm, NORM_FLOOR)`` (ext_growth.py:143)
NORM_FLOOR = 1e-37


class ExtendedForest(NamedTuple):
    """``indices``: int32 hyperplane coordinates, ``-1`` at leaves, holes
    and unused coordinates (``indices[..., 0] == -1`` marks a non-internal
    slot). ``weights``: float32, 0 where the coordinate is unused.
    ``offset``: float32 (the reference keeps a Double). ``num_instances``:
    int32 leaf size, ``-1`` at internal slots and holes."""

    indices: torch.Tensor  # i32 [T, M, k]
    weights: torch.Tensor  # f32 [T, M, k]
    offset: torch.Tensor  # f32 [T, M]
    num_instances: torch.Tensor  # i32 [T, M]

    @property
    def num_trees(self) -> int:
        return self.indices.shape[0]

    @property
    def max_nodes(self) -> int:
        return self.indices.shape[1]

    @property
    def k(self) -> int:
        return self.indices.shape[2]

    @property
    def height(self) -> int:
        return height_of(self.max_nodes)

    @property
    def device(self) -> torch.device:
        return self.indices.device

    @property
    def is_internal(self) -> torch.Tensor:
        return self.indices[..., 0] >= 0

    def to(self, device) -> "ExtendedForest":
        return ExtendedForest(*(a.to(device) for a in self))


# XLA:CPU's order for growth's three sums over k, as LLVM compiles the JAX
# package's program (jax 0.9.0, x86 with 256-bit vectors), read from the
# compiled code at k = 6 to 33 and held bitwise at k = 1 to 40, 48, 64, 100,
# 130 and 274 (tools/torch_port_ext_sum_orders.py): one FMA chain a row while the loop is
# unrolled (CHAIN_MAX); the norm's loop from 7 to 15 coordinates runs one
# 8-lane vector with its tail masked; from 16 to 32 the loop is vectorised
# along k as VECTOR[k] (DOT_VECTOR[k] for the dot) says: lanes, interleaved
# parts, lanes of the vectorised remainder (0: a scalar FMA chain); above 32
# XLA first splits the sum into windows of 32.
CHAIN_MAX = {"norm": 6, "offset": 15, "dot": 24}
VECTOR = {k: (8, 2, 0) for k in (16, 17)} | {k: (8, 2, 2) for k in (18, 19)} | {k: (4, 4, 4) for k in (20, 21)} \
    | {k: (4, 4, 2) for k in (22, 23)} | {k: (8, 1, 0) for k in range(24, 28)} \
    | {k: (4, 2, 0) for k in range(28, 32)} | {32: (8, 4, 0)}
DOT_VECTOR = {k: (8, 1, 0) for k in range(25, 28)} | {k: (4, 2, 0) for k in range(28, 32)} | {32: (8, 2, 0)}
WINDOW = 32


def _chain(a: torch.Tensor, b: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """``acc = fma(a_i, b_i, acc)`` over the last axis, in order."""
    for i in range(a.shape[-1]):
        acc = fma_f32(a[..., i], b[..., i], acc)
    return acc


def _lanes_sum(acc: torch.Tensor) -> torch.Tensor:
    """A vector's horizontal sum, halving: for eight lanes ``((l0 + l4) +
    (l2 + l6)) + ((l1 + l5) + (l3 + l7))``."""
    while acc.shape[-1] > 1:
        half = acc.shape[-1] // 2
        acc = acc[..., :half] + acc[..., half:]
    return acc[..., 0]


def _start(shape, lanes: int, first) -> torch.Tensor:
    """A reduction's start vector: ``first`` in lane 0, -0 in the others."""
    acc = torch.full(shape + (lanes,), -0.0, dtype=torch.float32, device=first.device)
    acc[..., 0] = first
    return acc


def _vectorised(a: torch.Tensor, b: torch.Tensor, lanes: int, ic: int, tail_lanes: int = 0,
                merged: bool = False) -> torch.Tensor:
    """The loop vectoriser's sum: ``ic`` parts of ``lanes`` lanes; part
    ``p`` takes the chunks ``it * ic + p``, part 0 from zeros. Its
    ``reassoc`` adds let the code generator fold each later part onto part 0
    as one FMA chain a lane (a part's first two chunks swapped, where it has
    more than one); then the lanes' sum. The remainder goes ``tail_lanes`` at
    a time from ``[sum, -0, ...]``, then as an FMA chain.
    ``merged``: the parts' adds were merged below a branch, away from the
    products computed above it, so those are rounded and added plainly; only
    the last part's product, computed below it too, still folds into an FMA."""
    k = a.shape[-1]
    iters = k // (lanes * ic)
    body = iters * ic * lanes
    zero = torch.zeros((), dtype=torch.float32, device=a.device)

    def chunk(c, width=lanes, at=0):
        return a[..., at + c * width : at + (c + 1) * width], b[..., at + c * width : at + (c + 1) * width]

    acc = _start(a.shape[:-1], lanes, zero)
    if merged:  # one iteration: the parts in order, from the start vector
        for c in range(ic - 1):
            x, y = chunk(c)
            acc = acc + x * y
        acc = fma_f32(*chunk(ic - 1), acc)
    else:
        for it in range(iters):
            acc = fma_f32(*chunk(it * ic), acc)
        for p in range(1, ic):
            chunks = [it * ic + p for it in range(iters)]
            if iters > 1:  # the part's second chunk, reassociated first
                chunks[:2] = chunks[1::-1]
            for c in chunks:
                acc = fma_f32(*chunk(c), acc)
    total = _lanes_sum(acc)
    if tail_lanes:
        n_tail = (k - body) // tail_lanes
        acc = _start(a.shape[:-1], tail_lanes, total)
        for c in range(n_tail):
            acc = fma_f32(*chunk(c, tail_lanes, body), acc)
        total, body = _lanes_sum(acc), body + n_tail * tail_lanes
    return _chain(a[..., body:], b[..., body:], total)


def _windowed(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """XLA's tree rewrite of a sum over more than 32 terms: the rounded
    products, zero-padded on both sides (the smaller half on the left) to
    whole windows of 32, each window summed in order, then the windows in
    order. Beyond 32 windows (1,024 terms) XLA nests the rewrite; that is
    not copied."""
    k = a.shape[-1]
    n_windows = -(-k // WINDOW)
    pad = n_windows * WINDOW - k
    prod = torch.nn.functional.pad(a * b, (pad // 2, pad - pad // 2))
    prod = prod.reshape(prod.shape[:-1] + (n_windows, WINDOW))
    acc = torch.zeros(prod.shape[:-1], dtype=torch.float32, device=a.device)
    for i in range(WINDOW):
        acc = acc + prod[..., i]
    total = torch.zeros(acc.shape[:-1], dtype=torch.float32, device=a.device)
    for w in range(n_windows):
        total = total + acc[..., w]
    return total


def row_dot(a: torch.Tensor, b: torch.Tensor, kind: str) -> torch.Tensor:
    """``sum(a * b)`` over the last axis in XLA:CPU's order for growth's sum
    ``kind`` (``"norm"``, ``"offset"`` or ``"dot"``) at this ``k``."""
    k = a.shape[-1]
    if k == 1:  # XLA drops a sum over one term: the bare product (-0 stays -0)
        return a[..., 0] * b[..., 0]
    if k > WINDOW:
        return _windowed(a, b)
    if k <= CHAIN_MAX[kind]:
        return _chain(a, b, torch.zeros(a.shape[:-1], dtype=torch.float32, device=a.device))
    if k < 16:  # the norm: one masked 8-lane vector a step, masked lanes adding nothing
        pad = (-k) % 8
        return _vectorised(torch.nn.functional.pad(a, (0, pad)), torch.nn.functional.pad(b, (0, pad)), 8, 1)
    # at k = 32 the offset's four parts are merged below its branch on empty
    # nodes (both sides of it reduce alike), away from the products
    plan = (DOT_VECTOR if kind == "dot" else VECTOR)[k]
    return _vectorised(a, b, *plan, merged=(kind == "offset" and k == WINDOW))


def _level_draws(level_key: torch.Tensor, l: int, w: int, fc: int, n_chunks: int, k: int):
    """One level's random draws for every tree: a function of the chunk
    ``c`` that draws its Gumbel values ``f32 [T, W, Fc]`` from
    ``fold_in(k_sub, c)`` when the chunk loop reaches it, the normal weights
    ``f32 [T, W, k]`` and the intercept uniforms ``f32 [T, W, k]``. ``l`` is
    unused here; a test that replaces this function to feed the JAX
    package's own draws reads it."""
    keys = prng.split(level_key, 3)
    k_sub, k_w, k_p = keys[:, 0], keys[:, 1], keys[:, 2]
    chunk_keys = prng.fold_in(k_sub[:, None, :], torch.arange(n_chunks, device=level_key.device))

    def chunk_gumbel(c: int) -> torch.Tensor:
        return prng.gumbel(chunk_keys[:, c], (w, fc))

    return chunk_gumbel, prng.normal(k_w, (w, k)), prng.uniform(k_p, (w, k))


def _top_k(g: torch.Tensor, i: torch.Tensor, k: int):
    """The ``k`` largest of ``g`` along the last axis with their ``i``, ties
    lower position first, as ``lax.top_k`` orders them (a stable descending
    sort; ``torch.topk`` breaks ties otherwise)."""
    order = torch.sort(g, dim=-1, descending=True, stable=True).indices[..., :k]
    return g.gather(-1, order), i.gather(-1, order)


def _grow_trees(tree_keys: torch.Tensor, x: torch.Tensor, h: int, k: int):
    """Grow one EIF tree per key over ``x: f32 [T, S, F]`` (each tree's own
    rows and features); returns local-coordinate-indexed heap tables."""
    num_trees, num_samples, f = x.shape
    dev = x.device
    m, w = 2 ** (h + 1) - 1, 2**h
    geom = lw.chunk_features(x)
    x, fc = geom.x, geom.chunk
    level_keys = prng.split(tree_keys, h + 1)  # [T, h + 1, 2]
    chunk_ids = torch.arange(fc, device=dev)

    node_id = torch.zeros((num_trees, num_samples), dtype=torch.int64, device=dev)
    settled = torch.zeros((num_trees, num_samples), dtype=torch.bool, device=dev)
    indices = torch.full((num_trees, m, k), -1, dtype=torch.int32, device=dev)
    weights = torch.zeros((num_trees, m, k), dtype=torch.float32, device=dev)
    offset = torch.zeros((num_trees, m), dtype=torch.float32, device=dev)
    num_instances = torch.full((num_trees, m), -1, dtype=torch.int32, device=dev)
    exists = torch.zeros((num_trees, m), dtype=torch.bool, device=dev)
    exists[:, 0] = True
    inf = float("inf")

    for l in range(h + 1):
        chunk_gumbel, normal, u = _level_draws(level_keys[:, l], l, w, fc, geom.n_chunks, k)
        win = lw.level_window(l, w, node_id, settled)
        idx = win.idx_of_sample
        cnt = torch.zeros((num_trees, w + 1), dtype=torch.int32, device=dev)
        cnt.scatter_add_(1, idx, torch.ones_like(idx, dtype=torch.int32))
        cnt = cnt[:, :w]

        # the subspace: k distinct coordinates per node, a Gumbel top-k kept
        # running across chunks; padded columns draw -inf and are never taken
        best_g = torch.full((num_trees, w, k), -inf, dtype=torch.float32, device=dev)
        best_i = torch.zeros((num_trees, w, k), dtype=torch.int64, device=dev)
        for c in range(geom.n_chunks):
            g = chunk_gumbel(c)
            if geom.pad and c == geom.n_chunks - 1:
                g = torch.where(chunk_ids < f - c * fc, g, -inf)
            ids = (c * fc + chunk_ids).expand(num_trees, w, fc)
            best_g, best_i = _top_k(torch.cat([best_g, g], dim=2), torch.cat([best_i, ids], dim=2), k)
        sub = best_i.sort(dim=2).values  # canonical ascending

        # statistics at the chosen coordinates only: each sample's values
        # there, then per-(tree, window row) min and max
        j_s = idx.clamp(max=w - 1)
        xv_s = x.gather(2, sub.gather(1, j_s[:, :, None].expand(-1, -1, k)))  # [T, S, k]
        mn = _scatter(inf, idx, xv_s, w, "amin")
        mx = _scatter(-inf, idx, xv_s, w, "amax")

        # the hyperplane; empty nodes' statistics are masked to stay finite
        nrm = prng.sqrt_f32(row_dot(normal, normal, "norm"))
        zero_norm = nrm == 0.0
        wv = normal / torch.clamp_min(nrm, NORM_FLOOR)[..., None]
        finite = (cnt > 0)[..., None]
        mn = torch.where(finite, mn, 0.0)
        mx = torch.where(finite, mx, 0.0)
        off = row_dot(wv, fma_f32(u, mx - mn, mn), "offset")

        exists_w = exists[:, win.start : win.start + w]
        can_split = exists_w & win.in_level & (cnt > 1) & (l < h) & ~zero_norm
        new_leaf = exists_w & win.in_level & ~can_split
        lw.patch(indices, sub, can_split[..., None], win.start)
        lw.patch(weights, wv, can_split[..., None], win.start)
        lw.patch(offset, off, can_split, win.start)
        lw.patch(num_instances, cnt, new_leaf, win.start)
        lw.spawn_children(exists, can_split, win)

        # route unsettled samples one level down (dot < offset left)
        split_here = can_split.gather(1, j_s) & ~settled
        dot = row_dot(xv_s, wv.gather(1, j_s[:, :, None].expand(-1, -1, k)), "dot")
        go_right = dot >= off.gather(1, j_s)
        node_id = torch.where(split_here, 2 * node_id + 1 + go_right.long(), node_id)
        settled = settled | ~split_here

    return indices, weights, offset, num_instances


def grow_extended_forest(
    tree_keys: torch.Tensor,
    X: torch.Tensor,
    bag_idx: torch.Tensor,
    feat_idx: torch.Tensor,
    height: int,
    extension_level: int,
) -> ExtendedForest:
    """Grow ``T`` extended isolation trees, all at once.

    ``tree_keys``: per-tree keys ``[T, 2]`` (:func:`.bagging.per_tree_keys`);
    ``X``: f32 ``[N, F_total]``; ``bag_idx``: i32 ``[T, S]``; ``feat_idx``:
    i32 ``[T, F_sub]`` sorted global feature ids; ``extension_level``: the
    resolved level, so a split takes ``min(extension_level + 1, F_sub)``
    coordinates. Local coordinates are mapped back to global feature ids,
    keeping the ``-1`` sentinels.
    """
    x_trees = gather_tree_data(X, bag_idx, feat_idx)
    k = min(extension_level + 1, x_trees.shape[2])
    local, weights, offset, num_instances = _grow_trees(tree_keys, x_trees, height, k)
    t = local.shape[0]
    glob = feat_idx.gather(1, local.clamp(min=0).reshape(t, -1).long()).reshape(local.shape)
    indices = torch.where(local >= 0, glob, -1).to(torch.int32)
    return ExtendedForest(indices=indices, weights=weights, offset=offset, num_instances=num_instances)
