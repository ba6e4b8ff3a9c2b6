"""O(h) node-id walk of an extended forest: the port of
``isoforest_tpu/ops/pallas_walk.py::_extended_walk``.

Host-side table builder, the CUDA kernel's wrapper (``csrc/ext_walk.cu``),
its plain PyTorch version and a launch counter. The wrapper returns the SUM
of path lengths over trees, as ``_extended_walk`` does;
:func:`path_lengths_ext_walk` divides by the real tree count
(``pallas_walk.py:438``).

Each hyperplane dot is rounded step by step in the order XLA gives the
reference (measured on the CPU, where the Pallas kernel runs in interpret
mode): up to ``PAIRED_MAX_K`` coordinates ``d = x1*w1; d = fma(x0, w0, d);
d = fma(xq, wq, d)`` for q >= 2, which is what XLA makes of
``_extended_walk_kernel``'s ``jnp.sum(jnp.stack(terms))``; above it, where
the reference's walk kernel stops (``_WALK_K_MAX``), the gather walk's
``d = fma(xq, wq, d)`` from 0. The plain version takes the same steps with
:func:`~isoforest_tpu_torch.utils.math.fma_f32`, so kernel and plain
version agree bit for bit, ties included.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..utils.math import fma_f32, height_of
from . import _build
from .ext_growth import ExtendedForest
from .scoring_layout import leaf_lut

# The reference walk kernel's k fence (pallas_walk.py:84). The port's walk
# takes any k; the fence only switches the dot's order (module docstring).
PAIRED_MAX_K = 16

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"ext_walk_sum": (_P, _I, _I, _P, _P, _P, _P, _I, _I, _I, _P, _P)}


class ExtWalkTables(NamedTuple):
    """Heap-order tables: ``offset`` f32 [T, M] (+inf at non-internal
    slots), ``index`` i32 and ``weight`` f32 [T, M, k] (0 at unused
    coordinates and non-internal slots), ``leaf`` f32 [T, M] (``depth +
    c(numInstances)`` at leaves, 0 at internal slots and holes) and
    ``min_features``, ``1 + max(index)``: the narrowest row the walk reads."""

    offset: torch.Tensor
    index: torch.Tensor
    weight: torch.Tensor
    leaf: torch.Tensor
    min_features: int

    @property
    def num_trees(self) -> int:
        return self.offset.shape[0]

    @property
    def height(self) -> int:
        return height_of(self.offset.shape[1])

    @property
    def k(self) -> int:
        return self.index.shape[2]


def walk_tables_extended(forest: ExtendedForest) -> ExtWalkTables:
    """Build the walk's tables on the CPU and move them to the forest's
    device (``walk_tables_extended``, ``pallas_walk.py:159``, in heap order).

    With +inf offsets a walk that passed its leaf keeps going left on the
    hole chain and every slot it visits adds the leaf table's 0, so exactly
    one slot per (row, tree) contributes: the exit leaf.
    """
    indices = forest.indices.detach().to("cpu", torch.int32)
    used = indices >= 0
    internal = used[..., 0]
    offset = torch.where(
        internal,
        forest.offset.detach().to("cpu", torch.float32),
        torch.tensor(float("inf"), dtype=torch.float32),
    )
    weight = torch.where(used, forest.weights.detach().to("cpu", torch.float32), torch.zeros((), dtype=torch.float32))
    index = indices.clamp(min=0)
    dev = forest.device
    return ExtWalkTables(
        offset=offset.contiguous().to(dev),
        index=index.contiguous().to(dev),
        weight=weight.contiguous().to(dev),
        leaf=leaf_lut(forest.num_instances, forest.max_nodes).contiguous().to(dev),
        min_features=int(index.max()) + 1 if index.numel() else 1,
    )


def hyperplane_dot(X: torch.Tensor, index: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Each row's dot with its node's hyperplane in the kernel's order.
    ``index``/``weight``: ``[N, k]``, the coordinates of each row's node."""
    k = index.shape[1]
    xv = X.gather(1, index.long())
    if 1 < k <= PAIRED_MAX_K:
        dot = xv[:, 1] * weight[:, 1]
        dot = fma_f32(xv[:, 0], weight[:, 0], dot)
        first = 2
    else:
        dot = torch.zeros(X.shape[0], dtype=torch.float32, device=X.device)
        first = 0
    for q in range(first, k):
        dot = fma_f32(xv[:, q], weight[:, q], dot)
    return dot


def ext_walk_sum_plain(X: torch.Tensor, tables: ExtWalkTables) -> torch.Tensor:
    """The kernel's function in plain PyTorch: each tree's exit-leaf value,
    summed over trees in tree order, ``f32[N]``."""
    n = X.shape[0]
    acc = torch.zeros(n, dtype=torch.float32, device=X.device)
    for t in range(tables.num_trees):
        off, idx, w, leaf = tables.offset[t], tables.index[t], tables.weight[t], tables.leaf[t]
        node = torch.zeros(n, dtype=torch.long, device=X.device)
        pl = leaf[node]
        for _ in range(tables.height):
            dot = hyperplane_dot(X, idx[node], w[node])
            node = 2 * node + 1 + (dot >= off[node]).long()
            pl = pl + leaf[node]  # +0.0 everywhere but at the exit leaf
        acc = acc + pl
    return acc


def ext_walk_sum(X: torch.Tensor, tables: ExtWalkTables) -> torch.Tensor:
    """Sum over trees of each row's path length, ``f32[N]``.

    On a CUDA tensor this launches ``csrc/ext_walk.cu`` and counts the
    launch in ``ext_walk_sum.launches``; on a CPU tensor it runs
    :func:`ext_walk_sum_plain`.
    """
    _check_inputs(X, tables)
    if X.device.type == "cpu":
        return ext_walk_sum_plain(X, tables)
    if X.device.type != "cuda":
        raise ValueError(f"ext_walk_sum runs on 'cuda' or 'cpu' tensors, got {X.device}")
    n, f = X.shape
    out = torch.empty(n, dtype=torch.float32, device=X.device)
    if n == 0:
        return out
    lib = _build.load("ext_walk", _SIGNATURES)
    err = lib.ext_walk_sum(
        X.data_ptr(), n, f,
        tables.offset.data_ptr(), tables.index.data_ptr(), tables.weight.data_ptr(), tables.leaf.data_ptr(),
        tables.num_trees, tables.height, tables.k, out.data_ptr(),
        torch.cuda.current_stream(X.device).cuda_stream,
    )
    _build.check(err, "ext_walk_sum")
    ext_walk_sum.launches += 1
    return out


ext_walk_sum.launches = 0


def _check_inputs(X: torch.Tensor, tables: ExtWalkTables) -> None:
    if X.dtype != torch.float32 or X.dim() != 2 or not X.is_contiguous():
        raise ValueError(f"X must be a contiguous float32 [N, F] tensor, got {X.dtype} {tuple(X.shape)}")
    if X.shape[1] < 1:
        raise ValueError("X needs at least one feature column")
    plane = tables.offset.shape
    shapes = (plane, plane + tables.index.shape[2:], plane + tables.index.shape[2:], plane)
    dtypes = (torch.float32, torch.int32, torch.float32, torch.float32)
    for name, a, dtype, shape in zip(tables._fields[:4], tables[:4], dtypes, shapes):
        if a.device != X.device or a.dtype != dtype or a.shape != shape or not a.is_contiguous():
            raise ValueError(
                f"walk table {name!r} must be a contiguous {dtype} {tuple(shape)} tensor "
                f"on {X.device}, got {a.dtype} {tuple(a.shape)} on {a.device}"
            )
    if X.shape[1] < tables.min_features:
        raise ValueError(f"X has {X.shape[1]} features, but the walk tables read feature {tables.min_features - 1}")
    if X.shape[0] >= 2**31 or tables.index.numel() >= 2**31:
        raise ValueError("the walk kernel takes fewer than 2^31 rows and table entries")


def path_lengths_ext_walk(X: torch.Tensor, tables: ExtWalkTables) -> torch.Tensor:
    """Mean path length over trees, ``f32[N]``: the walk's sum divided by the
    tree count (a device tensor, so the quotient is a true division)."""
    t = torch.tensor(float(tables.num_trees), dtype=torch.float32, device=X.device)
    return ext_walk_sum(X, tables) / t
