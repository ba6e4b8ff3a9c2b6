"""The merged value plane every scorer reads (``isoforest_tpu/ops/scoring_layout.py``).

Internal slots carry their split threshold (an extended forest's: its
hyperplane offset), leaf slots ``depth +
c(numInstances)`` (the exact path length a walk ending there credits,
IsolationTree.scala:213-229) and holes 0. Slot depth is static in the
implicit heap, so the merge moves the end-of-walk ``numInstances`` read and
the logarithm out of every inner loop. The planes are built on the CPU and
then moved to the forest's device, so every device reads the same bits.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.math import height_of, leaf_value_table
from .ext_growth import ExtendedForest
from .tree_growth import StandardForest


class StandardLayout(NamedTuple):
    """``value``: f32 [T, M] merged plane; ``feature``: i32 [T, M], -1 at
    leaves and holes."""

    value: torch.Tensor
    feature: torch.Tensor


def leaf_lut(num_instances: torch.Tensor, max_nodes: int) -> torch.Tensor:
    """``depth + c(numInstances)`` at leaves, 0 elsewhere: ``f32[T, M]`` on the CPU."""
    return leaf_value_table(num_instances, height_of(max_nodes))


def pack_standard(forest: StandardForest) -> StandardLayout:
    """Merged value plane and feature table, on the forest's device."""
    feature = forest.feature.detach().to("cpu", torch.int32)
    value = torch.where(
        feature >= 0,
        forest.threshold.detach().to("cpu", torch.float32),
        leaf_lut(forest.num_instances, forest.max_nodes),
    )
    dev = forest.device
    return StandardLayout(value=value.contiguous().to(dev), feature=feature.contiguous().to(dev))


class PackedExtendedLayout(NamedTuple):
    """Extended-forest analogue (``scoring_layout.py:110``): ``value`` f32
    [T, M] merges the hyperplane offset with the leaf LUT exactly like the
    standard layout; ``indices`` i32 / ``weights`` f32 [T, M, k] are the
    forest's hyperplanes. (The reference packs the three into one
    ``1 + 2k``-float record per node for one coalesced TPU gather; the
    port's walks read the planes.)"""

    value: torch.Tensor
    indices: torch.Tensor
    weights: torch.Tensor

    @property
    def k(self) -> int:
        return self.indices.shape[2]


def pack_extended(forest: ExtendedForest) -> PackedExtendedLayout:
    """Merged value plane and hyperplanes, on the forest's device
    (``pack_extended``, ``scoring_layout.py:162``)."""
    indices = forest.indices.detach().to("cpu", torch.int32)
    value = torch.where(
        indices[..., 0] >= 0,
        forest.offset.detach().to("cpu", torch.float32),
        leaf_lut(forest.num_instances, forest.max_nodes),
    )
    dev = forest.device
    return PackedExtendedLayout(
        value=value.contiguous().to(dev),
        indices=indices.contiguous().to(dev),
        weights=forest.weights.detach().to(dev, torch.float32).contiguous(),
    )
