"""Numeric primitives, params, input checks and logging, under the JAX
package's ``utils`` names."""

from .logging import logger, phase, set_level, trace
from .math import EULER_GAMMA, avg_path_length, height_limit, max_nodes_for, score_from_path_length
from .params import (
    ExtendedIsolationForestParams,
    IsolationForestParams,
    ResolvedParams,
    resolve_extension_level,
    resolve_params,
)
from .validation import (
    NONFINITE_POLICIES,
    UNKNOWN_TOTAL_NUM_FEATURES,
    check_non_finite,
    extract_features,
    validate_feature_vector_size,
)

__all__ = [
    "EULER_GAMMA",
    "avg_path_length",
    "height_limit",
    "max_nodes_for",
    "score_from_path_length",
    "ExtendedIsolationForestParams",
    "IsolationForestParams",
    "ResolvedParams",
    "resolve_extension_level",
    "resolve_params",
    "NONFINITE_POLICIES",
    "UNKNOWN_TOTAL_NUM_FEATURES",
    "check_non_finite",
    "extract_features",
    "validate_feature_vector_size",
    "logger",
    "phase",
    "set_level",
    "trace",
]
