"""Scoring kernels and their tables, growth, bagging, the quantile and the
streaming executor. The package exports what the JAX package's ``ops``
exports, where the port has it; the JAX layout names
(``PackedStandardLayout``, ``get_layout``, ``pack_forest``) have no
counterpart, because the port builds its tables per strategy
(:func:`.traversal.scoring_tables`)."""

from .bagging import bagged_indices, feature_subsets, gather_tree_data
from .dense import standard_path_lengths_dense
from .ext_dense import extended_path_lengths_dense
from .ext_growth import ExtendedForest, grow_extended_forest
from .quantile import contamination_threshold, exact_quantile, histogram_quantile, observed_contamination
from .scoring_layout import PackedExtendedLayout
from .streaming import StreamingExecutor, pipeline_enabled, pipeline_stats, resolve_chunk_rows
from .traversal import extended_path_lengths, path_lengths, path_lengths_dense, score_matrix, standard_path_lengths
from .tree_growth import StandardForest, grow_forest

__all__ = [
    "bagged_indices",
    "feature_subsets",
    "gather_tree_data",
    "extended_path_lengths_dense",
    "path_lengths_dense",
    "standard_path_lengths_dense",
    "ExtendedForest",
    "grow_extended_forest",
    "contamination_threshold",
    "exact_quantile",
    "histogram_quantile",
    "observed_contamination",
    "PackedExtendedLayout",
    "StreamingExecutor",
    "pipeline_enabled",
    "pipeline_stats",
    "resolve_chunk_rows",
    "extended_path_lengths",
    "path_lengths",
    "score_matrix",
    "standard_path_lengths",
    "StandardForest",
    "grow_forest",
]
