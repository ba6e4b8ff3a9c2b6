"""The fused training step over a mesh (``isoforest_tpu/parallel/train_step.py``).

Bagging, tree-parallel growth, row-parallel scoring of the training rows,
then the contamination threshold: the end-to-end multi-device path of a
fit whose forest need not leave the devices. The JAX package traces it into
one ``jit`` program; the port runs it as a plain function of the sharded
calls (:mod:`.sharded`), whose kernels launch asynchronously.

The training rows are scored where they lie: each rank keeps its own
shards' path length blocks, and the path lengths are gathered once, for the
returned scores (one ``exp2`` over all N, as
:func:`~.sharded.sharded_score`). The threshold: -1 without contamination;
with ``contamination_error == 0`` the exact rank pick ``ceil((1 - c) * N) -
1`` over the gathered scores; otherwise the distributed sketch
(:func:`~..ops.quantile.histogram_quantile_sharded`) over each rank's
scores of its own blocks, before the gather, whose min, max, per-pass
counts and final snap reduce with all-reduces. On a card ``exp2`` rounds an
element alike wherever it lies, so the threshold is an element of the
returned scores; on the CPU torch's ``exp2`` rounds by position (its
vector loop against its scalar tail), so there it is one where each rank's
blocks round as the gathered vector does, as at the tests' sizes.

The JAX step scores in blocks of 8 trees (a ``scan``), another sum order
than the walk kernel's, so the port's forest equals the JAX step's bitwise,
its scores come within float32 rounding of the JAX step's and equal the
port's own :func:`~.sharded.sharded_score` of that forest bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import prng
from ..ops.bagging import bagged_indices, feature_subsets, per_tree_keys
from ..ops.ext_growth import ExtendedForest
from ..ops.quantile import exact_quantile, histogram_quantile_sharded
from ..ops.tree_growth import StandardForest
from ..utils.math import height_limit, score_from_path_length
from .mesh import Mesh, gather_shards
from .sharded import (
    _local_path_lengths,
    resolve_sharded_strategy,
    sharded_grow_extended_forest,
    sharded_grow_forest,
)


class TrainStepResult(NamedTuple):
    forest: StandardForest | ExtendedForest
    scores: torch.Tensor  # f32[N] training-row scores, on the mesh's first local device
    threshold: torch.Tensor  # f32 scalar; -1 when contamination == 0


def make_train_step(
    mesh: Mesh,
    *,
    num_rows: int,
    num_features_total: int,
    num_trees: int,
    num_samples: int,
    num_features: int,
    bootstrap: bool = False,
    contamination: float = 0.0,
    contamination_error: float = 0.0,
    extended: bool = False,
    extension_level: int = 0,
    score_strategy: str = "auto",
):
    """A ``(key, X) -> TrainStepResult`` over ``mesh``: ``key`` a threefry
    key (``prng.PRNGKey(seed)``), ``X`` the ``[num_rows,
    num_features_total]`` training rows, the same on every rank.

    ``num_trees`` and ``num_rows`` must divide the shard count, as in the
    JAX package (pad upstream otherwise). ``score_strategy``: ``"auto"``
    (an eligible ``ISOFOREST_TPU_STRATEGY`` pin, else the walk; resolved
    here, before any forest exists), ``"walk"`` or ``"dense"``."""
    n_devices = mesh.size
    if num_trees % n_devices or num_rows % n_devices:
        raise ValueError(
            f"num_trees={num_trees} and num_rows={num_rows} must divide the "
            f"device count {n_devices} for the fused train step"
        )
    h = height_limit(num_samples)
    strategy = resolve_sharded_strategy(mesh, score_strategy)

    def train_step(key: torch.Tensor, X) -> TrainStepResult:
        dev = mesh.first_device
        X = torch.as_tensor(X, dtype=torch.float32).to(dev).contiguous()
        k_bag, k_feat, k_grow = prng.split(key.to(dev), 3)
        bag = bagged_indices(k_bag, num_rows, num_samples, num_trees, bootstrap)
        fidx = feature_subsets(k_feat, num_features_total, num_features, num_trees)
        tree_keys = per_tree_keys(k_grow, num_trees)
        if extended:
            forest = sharded_grow_extended_forest(mesh, tree_keys, X, bag, fidx, h, extension_level)
        else:
            forest = sharded_grow_forest(mesh, tree_keys, X, bag, fidx, h)
        # this rank's row blocks (num_rows divides the shards: no pad rows)
        parts = _local_path_lengths(mesh, forest, X, strategy, cache={})
        threshold = -1.0
        if contamination > 0.0 and contamination_error > 0.0:
            # the sketch reads the scores where they lie, before any gather
            mine = score_from_path_length(torch.cat([p.to(dev) for p in parts]), num_samples)
            threshold = histogram_quantile_sharded(mesh, mine, num_rows, 1.0 - contamination,
                                                   eps=contamination_error)
        # gathered for the result only; one exp2 over all N, as sharded_score
        scores = score_from_path_length(gather_shards(mesh, parts), num_samples)
        if contamination > 0.0 and contamination_error == 0.0:
            # exact rank pick == approxQuantile with error budget 0
            # (SharedTrainLogic.scala:187-197)
            threshold = exact_quantile(scores, 1.0 - contamination)
        return TrainStepResult(forest=forest, scores=scores,
                               threshold=torch.tensor(threshold, dtype=torch.float32, device=dev))

    return train_step


__all__ = ["TrainStepResult", "make_train_step"]
