"""O(h) node-id walk: the port of ``isoforest_tpu/ops/pallas_walk.py``.

Host-side table builder, the CUDA kernel's wrapper (``csrc/walk.cu``), its
plain PyTorch version and a launch counter. The wrapper returns the SUM of
path lengths over trees, as ``_standard_walk`` does; :func:`path_lengths_walk`
divides by the real tree count (``pallas_walk.py:438``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..utils.math import height_of
from . import _build
from .scoring_layout import leaf_lut
from .tree_growth import StandardForest

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"walk_sum": (_P, _I, _I, _P, _P, _P, _I, _I, _P, _P)}


class WalkTables(NamedTuple):
    """Heap-order node tables ``[T, M]``: ``threshold`` (+inf at
    non-internal slots), ``feature`` (clamped to >= 0) and ``leaf`` (``depth
    + c(numInstances)`` at leaves, 0 at internal slots and holes)."""

    threshold: torch.Tensor
    feature: torch.Tensor
    leaf: torch.Tensor

    @property
    def num_trees(self) -> int:
        return self.threshold.shape[0]

    @property
    def height(self) -> int:
        return height_of(self.threshold.shape[1])


def walk_tables(forest: StandardForest) -> WalkTables:
    """Build the walk's tables on the CPU and move them to the forest's device.

    With +inf thresholds a walk that passed its leaf keeps going left on the
    hole chain and every slot it visits adds the leaf table's 0, so exactly
    one slot per (row, tree) contributes: the exit leaf.
    """
    feature = forest.feature.detach().to("cpu", torch.int32)
    internal = feature >= 0
    thr = torch.where(
        internal,
        forest.threshold.detach().to("cpu", torch.float32),
        torch.tensor(float("inf"), dtype=torch.float32),
    )
    leaf = leaf_lut(forest.num_instances, forest.max_nodes)
    dev = forest.device
    return WalkTables(
        threshold=thr.contiguous().to(dev),
        feature=feature.clamp(min=0).contiguous().to(dev),
        leaf=leaf.contiguous().to(dev),
    )


def walk_sum_plain(X: torch.Tensor, tables: WalkTables) -> torch.Tensor:
    """The kernel's function in plain PyTorch: each tree's exit-leaf value,
    summed over trees in tree order, ``f32[N]``."""
    n = X.shape[0]
    acc = torch.zeros(n, dtype=torch.float32, device=X.device)
    for t in range(tables.num_trees):
        thr, feat, leaf = tables.threshold[t], tables.feature[t], tables.leaf[t]
        node = torch.zeros(n, dtype=torch.long, device=X.device)
        pl = leaf[node]
        for _ in range(tables.height):
            xv = X.gather(1, feat[node].long()[:, None])[:, 0]
            node = 2 * node + 1 + (xv >= thr[node]).long()
            pl = pl + leaf[node]  # +0.0 everywhere but at the exit leaf
        acc = acc + pl
    return acc


def walk_sum(X: torch.Tensor, tables: WalkTables) -> torch.Tensor:
    """Sum over trees of each row's path length, ``f32[N]``.

    On a CUDA tensor this launches ``csrc/walk.cu`` and counts the launch in
    ``walk_sum.launches``; on a CPU tensor it runs :func:`walk_sum_plain`.
    """
    _check_inputs(X, tables)
    if X.device.type == "cpu":
        return walk_sum_plain(X, tables)
    if X.device.type != "cuda":
        raise ValueError(f"walk_sum runs on 'cuda' or 'cpu' tensors, got {X.device}")
    n, f = X.shape
    out = torch.empty(n, dtype=torch.float32, device=X.device)
    if n == 0:
        return out
    lib = _build.load("walk", _SIGNATURES)
    err = lib.walk_sum(
        X.data_ptr(), n, f,
        tables.threshold.data_ptr(), tables.feature.data_ptr(), tables.leaf.data_ptr(),
        tables.num_trees, tables.height, out.data_ptr(),
        torch.cuda.current_stream(X.device).cuda_stream,
    )
    _build.check(err, "walk_sum")
    walk_sum.launches += 1
    return out


walk_sum.launches = 0


def _check_inputs(X: torch.Tensor, tables: WalkTables) -> None:
    if X.dtype != torch.float32 or X.dim() != 2 or not X.is_contiguous():
        raise ValueError(f"X must be a contiguous float32 [N, F] tensor, got {X.dtype} {tuple(X.shape)}")
    if X.shape[1] < 1:
        raise ValueError("X needs at least one feature column")
    shape = tables.threshold.shape
    for name, a, dtype in zip(tables._fields, tables, (torch.float32, torch.int32, torch.float32)):
        if a.device != X.device or a.dtype != dtype or a.shape != shape or not a.is_contiguous():
            raise ValueError(
                f"walk table {name!r} must be a contiguous {dtype} {tuple(shape)} tensor "
                f"on {X.device}, got {a.dtype} {tuple(a.shape)} on {a.device}"
            )
    if X.shape[0] >= 2**31 or tables.num_trees >= 2**31:
        raise ValueError("the walk kernel takes fewer than 2^31 rows and trees")


def path_lengths_walk(X: torch.Tensor, tables: WalkTables) -> torch.Tensor:
    """Mean path length over trees, ``f32[N]``: the walk's sum divided by the
    tree count (a device tensor, so the quotient is a true division)."""
    t = torch.tensor(float(tables.num_trees), dtype=torch.float32, device=X.device)
    return walk_sum(X, tables) / t
