"""O(h) node-id walk: the port of ``isoforest_tpu/ops/pallas_walk.py::_standard_walk``.

Host-side table builder, the CUDA kernel's wrapper (``walk_sum`` of
``csrc/path_walk.cu``, counted by :func:`.ext_path.launch` in
``ext_path.launches["walk_sum"]``) and its plain PyTorch version. The walk's
tables are the compact per-node records of :mod:`.ext_path`, header-only:
one ``(threshold, left, right, feature)`` record per internal node. The
wrapper returns the SUM of path lengths over trees in tree order, as
``_standard_walk`` does; :func:`path_lengths_walk` divides by the real tree
count (``pallas_walk.py:438``).
"""

from __future__ import annotations

import torch

from ..utils.math import height_of
from . import ext_path
from .ext_path import PathRecords
from .scoring_layout import leaf_lut
from .tree_growth import StandardForest


def walk_tables(forest: StandardForest) -> PathRecords:
    """Build the walk's records on the CPU and move them to the forest's
    device: each internal node's threshold, children and feature, a child
    code ``>= 0`` being the leaf LUT's ``depth + c(n)`` (+0.0 at a hole)."""
    feature = forest.feature.detach().to("cpu", torch.int32)
    return ext_path.build_path_records(
        internal=(feature >= 0).numpy(),
        offset=forest.threshold.detach().to("cpu", torch.float32).numpy(),
        leaf=leaf_lut(forest.num_instances, forest.max_nodes).numpy(),
        index=None,
        weight=None,
        terms=feature.numpy(),
        height=height_of(forest.max_nodes),
        device=forest.device,
    )


def walk_sum_plain(X: torch.Tensor, tables: PathRecords, tree_parallel: bool = False) -> torch.Tensor:
    """The kernel's function in plain PyTorch: each tree's exit-leaf value,
    summed over trees in tree order, ``f32[N]``; ``tree_parallel`` walks as
    the small-batch launch does, to the same sum."""
    return ext_path.path_sum_plain(X, tables, paired=False, mean=False, tree_parallel=tree_parallel)


def walk_sum(X: torch.Tensor, tables: PathRecords) -> torch.Tensor:
    """Sum over trees of each row's path length, ``f32[N]``.

    On a CUDA tensor this launches ``walk_sum`` of ``csrc/path_walk.cu``
    through :func:`.ext_path.launch`, which counts it in
    ``ext_path.launches["walk_sum"]``; on a CPU tensor it runs
    :func:`walk_sum_plain`.
    """
    ext_path.check_records(X, tables, "walk_sum")
    if X.device.type == "cpu":
        return walk_sum_plain(X, tables)
    return ext_path.launch("walk_sum", X, tables)


def path_lengths_walk(X: torch.Tensor, tables: PathRecords) -> torch.Tensor:
    """Mean path length over trees, ``f32[N]``: the walk's sum divided by the
    tree count (a device tensor, so the quotient is a true division; filled
    on the device, so nothing waits for the copy of a host scalar)."""
    t = torch.full((), float(tables.num_trees), dtype=torch.float32, device=X.device)
    return walk_sum(X, tables) / t
