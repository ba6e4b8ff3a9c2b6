"""The serving side of ``IsolationForestModel`` (``isoforest_tpu/models/isolation_forest.py:765-1150``).

A fitted standard forest that scores, predicts and transforms rows on its
device. Fit is not ported yet: a model comes from :meth:`IsolationForestModel.load`
or from arrays (:func:`isoforest_tpu_torch.io.interop.model_from_arrays`).
"""

from __future__ import annotations

import uuid
from typing import Optional

import torch

from ..ops.traversal import score_matrix
from ..ops.tree_growth import StandardForest
from ..utils.params import IsolationForestParams
from ..utils.validation import UNKNOWN_TOTAL_NUM_FEATURES


class IsolationForestModel:
    """Fitted model over a heap-tensor forest that lives on one device.

    Construction contract of IsolationForestModel.scala:37-78: a non-empty
    forest and ``numSamples >= 2``; ``outlierScoreThreshold`` starts at
    ``-1`` (unset), and labels are all zero until it is set (:142-148).
    """

    def __init__(
        self,
        forest: StandardForest,
        params: IsolationForestParams,
        num_samples: int,
        num_features: int,
        total_num_features: int = UNKNOWN_TOTAL_NUM_FEATURES,
        outlier_score_threshold: float = -1.0,
        uid: Optional[str] = None,
    ):
        if forest.num_trees < 1:
            raise ValueError("model requires a non-empty forest")
        if num_samples < 2:
            raise ValueError(f"numSamples must be >= 2, got {num_samples}")
        self.forest = forest
        self.params = params
        self.num_samples = int(num_samples)
        self.num_features = int(num_features)
        self.total_num_features = int(total_num_features)
        self.outlier_score_threshold = float(outlier_score_threshold)
        self.uid = uid or f"isolation-forest_{uuid.uuid4().hex[:12]}"
        # kernel tables and the width floor, built on first score
        self._cache: dict = {}

    @property
    def device(self) -> torch.device:
        return self.forest.device

    def set_outlier_score_threshold(self, value: float) -> "IsolationForestModel":
        """Override the threshold (IsolationForestModel.scala:86-95)."""
        if not (0.0 <= value <= 1.0 or value == -1.0):
            raise ValueError(
                f"outlierScoreThreshold must be in [0, 1] (or -1 = unset), got {value}"
            )
        self.outlier_score_threshold = float(value)
        return self

    def score(
        self,
        X,
        nonfinite: str = "warn",
        strategy: str = "auto",
        chunk_size: Optional[int] = None,
    ) -> torch.Tensor:
        """Outlier scores ``2^(-E[h(x)]/c(n))`` of an ``[N, F]`` matrix, as a
        float32 tensor on the model's device. ``nonfinite``: NaN/inf policy
        (``"warn"``/``"raise"``/``"allow"``); ``strategy``: ``"auto"``,
        ``"walk"`` or ``"dense"``."""
        expected = (
            self.total_num_features
            if self.total_num_features != UNKNOWN_TOTAL_NUM_FEATURES
            else None
        )
        return score_matrix(
            self.forest,
            X,
            self.num_samples,
            strategy=strategy,
            chunk_size=chunk_size,
            expected_features=expected,
            device=self.device,
            cache=self._cache,
            nonfinite=nonfinite,
        )

    def predict(self, scores: torch.Tensor) -> torch.Tensor:
        """Labels: ``score >= threshold`` when a threshold is set, else all
        zeros (IsolationForestModel.scala:142-148); float64, like the JAX
        package's."""
        scores = torch.as_tensor(scores)
        if self.outlier_score_threshold > 0:
            return (scores >= self.outlier_score_threshold).to(torch.float64)
        return torch.zeros_like(scores, dtype=torch.float64)

    def transform(self, X, nonfinite: str = "warn") -> dict:
        """Score and label columns of an ``[N, F]`` matrix, keyed by the
        params' ``scoreCol``/``predictionCol`` (IsolationForestModel.scala:116-151)."""
        scores = self.score(X, nonfinite=nonfinite)
        p = self.params
        return {p.score_col: scores.to(torch.float64), p.prediction_col: self.predict(scores)}

    @classmethod
    def load(cls, path: str, device=None, require_success: bool = True) -> "IsolationForestModel":
        """Load a model directory saved in the reference layout onto
        ``device`` (default: the card)."""
        from ..io.persistence import load_standard_model

        return load_standard_model(path, device=device, require_success=require_success)
