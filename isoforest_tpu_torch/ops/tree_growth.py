"""The standard forest container (``isoforest_tpu/ops/tree_growth.py:45-77``).

A forest is a struct of arrays over ``[num_trees, max_nodes]`` implicit-heap
slots; children of slot ``i`` live at ``2i+1`` / ``2i+2``. Growth is not
ported yet: forests come from a model file or from arrays
(:mod:`isoforest_tpu_torch.io.interop`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.math import height_of


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
