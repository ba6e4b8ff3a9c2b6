"""Carry a forest across from arrays: the JAX package's forest arrays (as
numpy) or any seeded synthetic forest become the port's forest and model.

``feature`` (int, ``-1`` at leaves and holes), ``threshold`` (float) and
``num_instances`` (int, ``-1`` at internal slots and holes) are
``[num_trees, 2^(h+1) - 1]`` implicit-heap arrays, exactly the fields of
``isoforest_tpu.ops.tree_growth.StandardForest``.
"""

from __future__ import annotations

import torch

from ..ops.tree_growth import StandardForest
from ..utils.device import resolve_device
from ..utils.params import IsolationForestParams
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
