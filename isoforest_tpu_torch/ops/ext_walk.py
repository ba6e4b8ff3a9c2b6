"""O(h) node-id walk of an extended forest: the port of
``isoforest_tpu/ops/pallas_walk.py::_extended_walk``.

Host-side table builder, the CUDA kernel's wrapper (``ext_walk_sum`` of
``csrc/path_walk.cu``, counted by :func:`.ext_path.launch`) and its plain
PyTorch version. The walk's tables are the compact per-node records of :mod:`.ext_path`, which
the sparse-hyperplane level walk shares. The wrapper returns the SUM of
path lengths over trees, as ``_extended_walk`` does;
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

import torch

from ..utils.math import height_of
from . import ext_path
from .ext_growth import ExtendedForest
from .ext_path import PAIRED_MAX_K, PathRecords
from .scoring_layout import leaf_lut


def walk_tables_extended(forest: ExtendedForest) -> PathRecords:
    """Build the walk's records on the CPU and move them to the forest's
    device (the node-major content of ``walk_tables_extended``,
    ``pallas_walk.py:159``: offsets of internal nodes, indices clamped to 0
    and weights 0 at unused coordinates, so each record holds k terms, the
    leaf LUT ``depth + c(n)``)."""
    indices = forest.indices.detach().to("cpu", torch.int32)
    used = indices >= 0
    weight = torch.where(used, forest.weights.detach().to("cpu", torch.float32), torch.zeros((), dtype=torch.float32))
    k = indices.shape[2]
    return ext_path.build_path_records(
        internal=used[..., 0].numpy(),
        offset=forest.offset.detach().to("cpu", torch.float32).numpy(),
        leaf=leaf_lut(forest.num_instances, forest.max_nodes).numpy(),
        index=indices.clamp(min=0).numpy(),
        weight=weight.numpy(),
        terms=torch.full(indices.shape[:2], k, dtype=torch.int32).numpy(),
        height=height_of(forest.max_nodes),
        device=forest.device,
    )


def ext_walk_sum_plain(X: torch.Tensor, tables: PathRecords) -> torch.Tensor:
    """The kernel's function in plain PyTorch: each tree's exit-leaf value,
    summed over trees in tree order, ``f32[N]``."""
    return ext_path.path_sum_plain(X, tables, paired=1 < tables.k <= PAIRED_MAX_K, mean=False)


def ext_walk_sum(X: torch.Tensor, tables: PathRecords) -> torch.Tensor:
    """Sum over trees of each row's path length, ``f32[N]``.

    On a CUDA tensor this launches ``ext_walk_sum`` of ``csrc/path_walk.cu``
    through :func:`.ext_path.launch`, which counts it in
    ``ext_path.launches["ext_walk_sum"]``; on a CPU tensor it runs
    :func:`ext_walk_sum_plain`.
    """
    ext_path.check_records(X, tables, "ext_walk_sum")
    if X.device.type == "cpu":
        return ext_walk_sum_plain(X, tables)
    return ext_path.launch("ext_walk_sum", X, tables)


def path_lengths_ext_walk(X: torch.Tensor, tables: PathRecords) -> torch.Tensor:
    """Mean path length over trees, ``f32[N]``: the walk's sum divided by the
    tree count (a device tensor, so the quotient is a true division; filled
    on the device, so nothing waits for the copy of a host scalar)."""
    t = torch.full((), float(tables.num_trees), dtype=torch.float32, device=X.device)
    return ext_walk_sum(X, tables) / t
