"""The merged value plane every scorer reads (``isoforest_tpu/ops/scoring_layout.py``).

Internal slots carry their split threshold (an extended forest's: its
hyperplane offset), leaf slots ``depth +
c(numInstances)`` (the exact path length a walk ending there credits,
IsolationTree.scala:213-229) and holes 0. Slot depth is static in the
implicit heap, so the merge moves the end-of-walk ``numInstances`` read and
the logarithm out of every inner loop. The planes are built on the CPU and
then moved to the forest's device, so every device reads the same bits.
The quantized (q16) plane below packs a standard node into 32 bits.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
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


# -- the quantized (q16) plane (``scoring_layout.py:198-396``) -------------
#
# The standard plane stores one 32-bit record per node, ``code << 16 |
# feature``, beside two tables shared by the whole forest: ``edges``, the
# sorted distinct internal thresholds, and ``lut``, the distinct leaf values
# ``depth + c(n)`` (the f32 plane's own bits; ``lut[0]`` is 0.0, what a hole
# credits). An internal node's code is its threshold's rank in ``edges``, a
# leaf's its value's index in ``lut``; leaves and holes carry the feature
# sentinel 0xFFFF. Rows binarize to ranks ``rx = #(edges <= x)``, and
# ``rx > code`` is exactly ``x >= threshold``, so the rank walk takes the
# f32 walk's branch at every node and credits the f32 plane's leaf bits.
# torch's uint32 lacks shifts and gathers on the card, so the records are
# the u32 bits in an int32 tensor. The extended plane narrows the
# hyperplane indices to int16; its weights and merged values stay float32.

# u16 capacities: ranks 0..E and LUT indices fit when E, U <= 65,535;
# feature ids stay below the sentinel; EIF indices fit int16 (-1 padding)
_Q16_MAX_EDGES = 65535
_Q16_MAX_LUT = 65535
_Q16_FEATURE_SENTINEL = 0xFFFF
_Q16_MAX_FEATURE_ID = _Q16_FEATURE_SENTINEL - 1
_Q16_EXT_MAX_FEATURE_ID = 32767


class QuantizedStandardLayout(NamedTuple):
    """``packed``: int32 [T, M], the u32 bits ``code << 16 | feature``;
    ``edges``: f32 [E] sorted distinct internal thresholds; ``lut``: f32
    [U] distinct leaf values, ``lut[0] == 0.0``."""

    packed: torch.Tensor
    edges: torch.Tensor
    lut: torch.Tensor

    @property
    def num_trees(self) -> int:
        return self.packed.shape[0]


class QuantizedExtendedLayout(NamedTuple):
    """``indices``: int16 [T, M, k], -1 padding; ``weights``: f32 [T, M, k];
    ``value``: f32 [T, M], the merged plane of :func:`pack_extended`."""

    indices: torch.Tensor
    weights: torch.Tensor
    value: torch.Tensor

    @property
    def num_trees(self) -> int:
        return self.value.shape[0]


def quantized_unsupported_reason(forest, cache: Optional[dict] = None) -> Optional[str]:
    """None when the forest fits the q16 plane, else why not: more than
    65,535 distinct thresholds or leaf values, a feature id at the 0xFFFF
    sentinel (an EIF hyperplane index above int16's 32,767). The distinct
    counts are host reductions over ``[T, M]``, copied from the forest's
    device, so a caller that asks per call passes ``cache``, the dict it
    keeps per forest (a model's table cache): the verdict is computed once
    and kept there under ``"q16_reason"``."""
    if cache is not None and "q16_reason" in cache:
        return cache["q16_reason"]
    reason = _quantized_unsupported_reason_uncached(forest)
    if cache is not None:
        cache["q16_reason"] = reason
    return reason


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu").numpy()


def _quantized_unsupported_reason_uncached(forest) -> Optional[str]:
    if isinstance(forest, ExtendedForest):
        idx = _host(forest.indices)
        max_id = int(idx.max()) if idx.size else -1
        if max_id > _Q16_EXT_MAX_FEATURE_ID:
            return f"hyperplane coordinate {max_id} exceeds the i16 index maximum {_Q16_EXT_MAX_FEATURE_ID}"
        return None
    feat = _host(forest.feature)
    max_id = int(feat.max()) if feat.size else -1
    if max_id > _Q16_MAX_FEATURE_ID:
        return f"feature id {max_id} exceeds the u16 plane's maximum {_Q16_MAX_FEATURE_ID}"
    n_edges = np.unique(_host(forest.threshold)[feat >= 0]).size
    if n_edges > _Q16_MAX_EDGES:
        return f"{n_edges} distinct thresholds exceed the u16 rank capacity {_Q16_MAX_EDGES}"
    n_lut = np.unique(leaf_lut(forest.num_instances, forest.max_nodes).numpy()).size
    if n_lut > _Q16_MAX_LUT:
        return f"{n_lut} distinct leaf values exceed the u16 LUT capacity {_Q16_MAX_LUT}"
    return None


def quantized_eligible(forest, cache: Optional[dict] = None) -> bool:
    return quantized_unsupported_reason(forest, cache) is None


def pack_standard_q(forest: StandardForest) -> QuantizedStandardLayout:
    """The rank-space plane of a standard forest, built on the host with
    numpy (``np.unique``, ``np.searchsorted``, as the JAX package builds
    it) and moved to the forest's device once."""
    feat = _host(forest.feature).astype(np.int64)
    internal = feat >= 0
    thr = _host(forest.threshold).astype(np.float32)
    leaf_vals = leaf_lut(forest.num_instances, forest.max_nodes).numpy()
    edges = np.unique(thr[internal]).astype(np.float32)
    lut = np.unique(np.concatenate([[np.float32(0.0)], leaf_vals[~internal]])).astype(np.float32)
    code = np.zeros(feat.shape, np.uint32)
    code[internal] = np.searchsorted(edges, thr[internal]).astype(np.uint32)
    code[~internal] = np.searchsorted(lut, leaf_vals[~internal]).astype(np.uint32)
    feat_u16 = np.where(internal, feat, _Q16_FEATURE_SENTINEL).astype(np.uint32)
    packed = (code << np.uint32(16)) | feat_u16
    dev = forest.device
    return QuantizedStandardLayout(
        packed=torch.from_numpy(packed.view(np.int32)).to(dev),
        edges=torch.from_numpy(edges).to(dev),
        lut=torch.from_numpy(lut).to(dev),
    )


def pack_extended_q(forest: ExtendedForest) -> QuantizedExtendedLayout:
    """The extended plane: int16 hyperplane indices, the float32 weights and
    the merged value plane of :func:`pack_extended`, bit for bit."""
    f32 = pack_extended(forest)
    return QuantizedExtendedLayout(indices=f32.indices.to(torch.int16), weights=f32.weights, value=f32.value)


def pack_forest_q(forest):
    if isinstance(forest, ExtendedForest):
        return pack_extended_q(forest)
    return pack_standard_q(forest)


def layout_nbytes(tables) -> int:
    """Bytes of the tensors of a table NamedTuple (a layout or a kernel's
    records), its shared side tables included."""
    return sum(int(a.numel()) * a.element_size() for a in tables if isinstance(a, torch.Tensor))
