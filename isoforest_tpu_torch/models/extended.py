"""The serving side of ``ExtendedIsolationForestModel``
(``isoforest_tpu/models/extended.py:264-315``).

A fitted extended (EIF) forest that scores, predicts and transforms rows on
its device. Scoring dispatches on the forest's type
(ExtendedIsolationForestModel.scala:98-135); only the recorded
``extension_level`` and loading differ from the standard model. EIF fit is
not ported yet: a model comes from :meth:`ExtendedIsolationForestModel.load` or
from arrays (:func:`isoforest_tpu_torch.io.interop.extended_model_from_arrays`).
"""

from __future__ import annotations

import uuid
from typing import Optional

from ..ops.ext_growth import ExtendedForest
from ..utils.params import ExtendedIsolationForestParams
from ..utils.validation import UNKNOWN_TOTAL_NUM_FEATURES
from .isolation_forest import IsolationForestModel


class ExtendedIsolationForestModel(IsolationForestModel):
    """Fitted EIF model over a heap-tensor forest that lives on one device."""

    def __init__(
        self,
        forest: ExtendedForest,
        params: ExtendedIsolationForestParams,
        num_samples: int,
        num_features: int,
        extension_level: int,
        total_num_features: int = UNKNOWN_TOTAL_NUM_FEATURES,
        outlier_score_threshold: float = -1.0,
        uid: Optional[str] = None,
    ):
        super().__init__(
            forest=forest,
            params=params,
            num_samples=num_samples,
            num_features=num_features,
            total_num_features=total_num_features,
            outlier_score_threshold=outlier_score_threshold,
            uid=uid or f"extended-isolation-forest_{uuid.uuid4().hex[:12]}",
        )
        self.extension_level = int(extension_level)

    @classmethod
    def load(
        cls, path: str, device=None, require_success: bool = True, verify="auto"
    ) -> "ExtendedIsolationForestModel":
        """Load an extended model directory saved in the reference layout
        onto ``device`` (default: the card); ``verify`` checks its manifest
        (``"auto"``: when there is one)."""
        from ..io.persistence import load_extended_model

        return load_extended_model(path, device=device, require_success=require_success, verify=verify)
