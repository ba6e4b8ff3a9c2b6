"""Carry a forest across from arrays: the JAX package's forest arrays (as
numpy) or any seeded synthetic forest become the port's forest and model.

Standard: ``feature`` (int, ``-1`` at leaves and holes), ``threshold``
(float) and ``num_instances`` (int, ``-1`` at internal slots and holes) are
``[num_trees, 2^(h+1) - 1]`` implicit-heap arrays, exactly the fields of
``isoforest_tpu.ops.tree_growth.StandardForest``. Extended: ``indices``
(int, ``[T, M, k]``, ``-1`` where unused), ``weights`` (float, ``[T, M,
k]``), ``offset`` (float, ``[T, M]``) and ``num_instances``, the fields of
``isoforest_tpu.ops.ext_growth.ExtendedForest``.
"""

from __future__ import annotations

import torch

from ..ops.ext_growth import ExtendedForest
from ..ops.tree_growth import StandardForest
from ..utils.device import resolve_device
from ..utils.params import ExtendedIsolationForestParams, IsolationForestParams
from ..utils.validation import UNKNOWN_TOTAL_NUM_FEATURES


def forest_from_arrays(feature, threshold, num_instances, device=None) -> StandardForest:
    """Build a :class:`StandardForest` on ``device`` (default: the card)."""
    dev = resolve_device(device)
    arrays = [
        torch.as_tensor(a).to(dev, dtype)
        for a, dtype in (
            (feature, torch.int32),
            (threshold, torch.float32),
            (num_instances, torch.int32),
        )
    ]
    shape = arrays[0].shape
    if len(shape) != 2 or any(a.shape != shape for a in arrays):
        raise ValueError(
            "feature, threshold and num_instances must share one [T, M] shape, got "
            + ", ".join(str(tuple(a.shape)) for a in arrays)
        )
    t, m = shape
    if t < 1 or m < 1 or (m + 1) & m:
        raise ValueError(f"a forest needs >= 1 tree of 2^(h+1)-1 heap slots, got [{t}, {m}]")
    return StandardForest(*(a.contiguous() for a in arrays))


def model_from_arrays(
    feature,
    threshold,
    num_instances,
    num_samples: int,
    num_features: int,
    total_num_features: int = UNKNOWN_TOTAL_NUM_FEATURES,
    outlier_score_threshold: float = -1.0,
    params: IsolationForestParams | None = None,
    device=None,
):
    """Build an :class:`~isoforest_tpu_torch.models.IsolationForestModel`
    from forest arrays, on ``device`` (default: the card)."""
    from ..models.isolation_forest import IsolationForestModel

    return IsolationForestModel(
        forest=forest_from_arrays(feature, threshold, num_instances, device=device),
        params=params if params is not None else IsolationForestParams(),
        num_samples=num_samples,
        num_features=num_features,
        total_num_features=total_num_features,
        outlier_score_threshold=outlier_score_threshold,
    )


def extended_forest_from_arrays(indices, weights, offset, num_instances, device=None) -> ExtendedForest:
    """Build an :class:`ExtendedForest` on ``device`` (default: the card)."""
    dev = resolve_device(device)
    idx, w, off, ni = (
        torch.as_tensor(a).to(dev, dtype).contiguous()
        for a, dtype in (
            (indices, torch.int32),
            (weights, torch.float32),
            (offset, torch.float32),
            (num_instances, torch.int32),
        )
    )
    if idx.dim() != 3 or w.shape != idx.shape or off.shape != idx.shape[:2] or ni.shape != off.shape:
        raise ValueError(
            "indices and weights must share one [T, M, k] shape and offset and "
            f"num_instances be [T, M], got {tuple(idx.shape)}, {tuple(w.shape)}, "
            f"{tuple(off.shape)}, {tuple(ni.shape)}"
        )
    t, m, k = idx.shape
    if t < 1 or m < 1 or k < 1 or (m + 1) & m:
        raise ValueError(f"an extended forest needs >= 1 tree of 2^(h+1)-1 heap slots and k >= 1, got [{t}, {m}, {k}]")
    return ExtendedForest(idx, w, off, ni)


def extended_model_from_arrays(
    indices,
    weights,
    offset,
    num_instances,
    num_samples: int,
    num_features: int,
    extension_level: int | None = None,
    total_num_features: int = UNKNOWN_TOTAL_NUM_FEATURES,
    outlier_score_threshold: float = -1.0,
    params: ExtendedIsolationForestParams | None = None,
    device=None,
):
    """Build an :class:`~isoforest_tpu_torch.models.ExtendedIsolationForestModel`
    from EIF arrays, on ``device`` (default: the card). ``extension_level``
    defaults to ``k - 1``."""
    from ..models.extended import ExtendedIsolationForestModel

    forest = extended_forest_from_arrays(indices, weights, offset, num_instances, device=device)
    return ExtendedIsolationForestModel(
        forest=forest,
        params=params if params is not None else ExtendedIsolationForestParams(),
        num_samples=num_samples,
        num_features=num_features,
        extension_level=forest.k - 1 if extension_level is None else extension_level,
        total_num_features=total_num_features,
        outlier_score_threshold=outlier_score_threshold,
    )
