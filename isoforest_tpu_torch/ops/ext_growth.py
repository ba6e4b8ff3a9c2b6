"""The extended (EIF) forest container (``isoforest_tpu/ops/ext_growth.py:38-68``).

Each internal node holds a sparse hyperplane: ``k`` coordinates and their
weights, and the offset; rows with ``dot(x, w) < offset`` go left
(ExtendedIsolationTree.scala:230-232). Growth is not ported yet: forests
come from a model file or from arrays (:mod:`isoforest_tpu_torch.io.interop`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.math import height_of


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
