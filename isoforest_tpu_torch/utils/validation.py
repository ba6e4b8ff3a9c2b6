"""Input checks of fit and scoring (``isoforest_tpu/utils/validation.py``).

The reference's schema checks (``core/Utils.scala:35-72``): the features
column is vector-valued, output columns must not exist yet, and at scoring
time the width matches the training width when it is known
(``UnknownTotalNumFeatures = -1``, IsolationForestModel.scala:171); and the
NaN/inf policy. Inputs are tensors, arrays or pandas DataFrames, the
Dataset's analogue.
"""

from __future__ import annotations

import logging
from typing import Optional, Tuple

import numpy as np
import torch

UNKNOWN_TOTAL_NUM_FEATURES = -1

NONFINITE_POLICIES = ("warn", "raise", "allow")

logger = logging.getLogger("isoforest_tpu_torch")


def extract_features(
    data,
    features_col: str = "features",
    output_cols: Tuple[str, ...] = (),
    nonfinite: str = "warn",
    device=None,
) -> Tuple[torch.Tensor, Optional[object]]:
    """Normalise input to a float32 ``[N, F]`` tensor on ``device`` (default:
    where a tensor already is, else the CPU).

    Accepts an ``[N, F]`` tensor or array-like, or a pandas DataFrame whose
    ``features_col`` holds one vector per row (core/Utils.scala:35-65).
    Returns ``(X, frame_or_None)``; the frame comes back so ``transform``
    can append its columns. Refuses a frame that already has one of
    ``output_cols`` (Utils.scala:47-58), then applies the ``nonfinite``
    policy on ``X``'s device.
    """
    pd = None
    if type(data).__module__.startswith("pandas"):  # no import attempt for tensors
        try:
            import pandas as pd
        except ImportError:
            pd = None
    frame = None
    if pd is not None and isinstance(data, pd.DataFrame):
        if features_col not in data.columns:
            raise ValueError(
                f"features column {features_col!r} not found in input DataFrame "
                f"(columns: {list(data.columns)})"
            )
        for col in output_cols:
            if col in data.columns:
                raise ValueError(f"output column {col!r} already exists in the input DataFrame")
        first = data[features_col].iloc[0] if len(data) else None
        if first is not None and np.ndim(first) == 0:
            raise ValueError(
                f"features column {features_col!r} must be vector-valued "
                f"(each cell an array of floats), got scalar {type(first).__name__}"
            )
        frame = data
        data = np.stack(data[features_col].to_numpy()) if len(data) else np.zeros((0, 0))
    if isinstance(data, np.ndarray):
        data = torch.from_numpy(np.ascontiguousarray(data, dtype=np.float32))
    X = torch.as_tensor(data)
    X = X.to(X.device if device is None else device, torch.float32).contiguous()
    if X.dim() != 2:
        raise ValueError(f"expected a 2-D [num_rows, num_features] matrix, got shape {tuple(X.shape)}")
    check_non_finite(X, nonfinite)
    return X, frame


def check_nonfinite_policy(policy: str) -> None:
    if policy not in NONFINITE_POLICIES:
        raise ValueError(
            f"nonfinite policy must be one of {NONFINITE_POLICIES}, got {policy!r}"
        )


def check_non_finite(X: torch.Tensor, policy: str = "warn") -> None:
    """NaN/inf input policy: ``"warn"`` logs once per call, ``"raise"``
    raises ValueError, ``"allow"`` is silent. Trees compare with ``>=``, so
    NaN goes left at every node."""
    check_nonfinite_policy(policy)
    if policy == "allow" or X.numel() == 0:
        return
    report_non_finite(int(count_non_finite(X)), policy)


def count_non_finite(X: torch.Tensor) -> torch.Tensor:
    """The count of NaN/inf values in ``X``, an int64 scalar on ``X``'s
    device (no synchronisation). A streamed call adds one per chunk and
    reads the total once, with :func:`report_non_finite`."""
    return (~torch.isfinite(X)).sum()


def report_non_finite(bad: int, policy: str) -> None:
    """Apply ``policy`` to ``bad`` non-finite values: the message of
    :func:`check_non_finite`, logged (``"warn"``) or raised (``"raise"``)."""
    if policy == "allow" or not bad:
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
