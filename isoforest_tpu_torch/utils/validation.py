"""Input checks of the scoring path (``isoforest_tpu/utils/validation.py``).

The NaN/inf policy and the scoring-time width check of the reference
(``core/Utils.scala:67-72``; ``UnknownTotalNumFeatures = -1``,
IsolationForestModel.scala:171), on tensors.
"""

from __future__ import annotations

import logging

import torch

UNKNOWN_TOTAL_NUM_FEATURES = -1

NONFINITE_POLICIES = ("warn", "raise", "allow")

logger = logging.getLogger("isoforest_tpu_torch")


def check_non_finite(X: torch.Tensor, policy: str = "warn") -> None:
    """NaN/inf input policy: ``"warn"`` logs once per call, ``"raise"``
    raises ValueError, ``"allow"`` is silent. Trees compare with ``>=``, so
    NaN goes left at every node."""
    if policy not in NONFINITE_POLICIES:
        raise ValueError(
            f"nonfinite policy must be one of {NONFINITE_POLICIES}, got {policy!r}"
        )
    if policy == "allow" or X.numel() == 0:
        return
    bad = int((~torch.isfinite(X)).sum())
    if not bad:
        return
    msg = (
        f"input contains {bad} non-finite feature values (nan/inf); isolation "
        "trees treat them as incomparable and scores may be degraded"
    )
    if policy == "raise":
        raise ValueError(msg + " (nonfinite='raise')")
    logger.warning("%s", msg)


def validate_feature_vector_size(num_features: int, expected: int) -> None:
    """Scoring-time width check (core/Utils.scala:67-72): skipped when the
    training width is unknown (legacy models, sentinel -1)."""
    if expected != UNKNOWN_TOTAL_NUM_FEATURES and num_features != expected:
        raise ValueError(
            f"feature vector has {num_features} features, but the model was "
            f"trained on {expected}"
        )
