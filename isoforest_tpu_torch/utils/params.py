"""Hyper-parameters of the standard and extended forests, with the reference's names,
defaults and validators (``isoforest_tpu/utils/params.py``;
``core/IsolationForestParamsBase.scala:8-110``), and their fit-time
resolution of fractions and counts (``core/SharedTrainLogic.scala:33-77``).

Scoring reads none of them; a loaded model keeps them so its metadata
round-trips.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional

# camelCase names of the persisted paramMap
# (core/IsolationForestModelReadWriteUtils.scala:163-187).
_PARAM_JSON_NAMES = {
    "num_estimators": "numEstimators",
    "max_samples": "maxSamples",
    "contamination": "contamination",
    "contamination_error": "contaminationError",
    "max_features": "maxFeatures",
    "bootstrap": "bootstrap",
    "random_seed": "randomSeed",
    "features_col": "featuresCol",
    "prediction_col": "predictionCol",
    "score_col": "scoreCol",
}


@dataclass(frozen=True)
class IsolationForestParams:
    """Base hyper-parameters (defaults: IsolationForestParamsBase.scala:98-109)."""

    num_estimators: int = 100
    max_samples: float = 256.0
    contamination: float = 0.0
    contamination_error: float = 0.0
    max_features: float = 1.0
    bootstrap: bool = False
    random_seed: int = 1
    features_col: str = "features"
    prediction_col: str = "predictedLabel"
    score_col: str = "outlierScore"

    def __post_init__(self):
        if not isinstance(self.num_estimators, int) or self.num_estimators <= 0:
            raise ValueError(
                f"numEstimators must be a positive int, got {self.num_estimators}"
            )
        if not self.max_samples > 0:
            raise ValueError(f"maxSamples must be > 0, got {self.max_samples}")
        if not (0.0 <= self.contamination < 0.5):
            raise ValueError(
                f"contamination must be in [0, 0.5), got {self.contamination}"
            )
        if not (0.0 <= self.contamination_error <= 1.0):
            raise ValueError(
                f"contaminationError must be in [0, 1], got {self.contamination_error}"
            )
        if not self.max_features > 0:
            raise ValueError(f"maxFeatures must be > 0, got {self.max_features}")
        if not isinstance(self.bootstrap, bool):
            raise ValueError(f"bootstrap must be a bool, got {self.bootstrap!r}")

    def replace(self, **kw) -> "IsolationForestParams":
        return dataclasses.replace(self, **kw)

    def to_param_map(self) -> dict:
        """camelCase paramMap dict as persisted in model metadata JSON."""
        out = {json_name: getattr(self, field) for field, json_name in _PARAM_JSON_NAMES.items()}
        # the reference persists maxSamples/maxFeatures as doubles (256.0)
        out["maxSamples"] = float(out["maxSamples"])
        out["maxFeatures"] = float(out["maxFeatures"])
        return out

    @classmethod
    def from_param_map(cls, param_map: dict) -> "IsolationForestParams":
        """Re-hydrate from a persisted paramMap; unknown keys are ignored
        (core/IsolationForestModelReadWriteUtils.scala:72-84)."""
        inverse = {v: k for k, v in _PARAM_JSON_NAMES.items()}
        kw = {}
        for json_name, value in param_map.items():
            field = inverse.get(json_name)
            if field is None:
                continue
            if field in ("num_estimators", "random_seed"):
                value = int(value)
            elif field == "bootstrap":
                value = bool(value)
            elif field in ("max_samples", "contamination", "contamination_error", "max_features"):
                value = float(value)
            kw[field] = value
        return cls(**kw)


@dataclass(frozen=True)
class ExtendedIsolationForestParams(IsolationForestParams):
    """Adds ``extensionLevel`` (>= 0, unset by default; resolved at fit to
    ``numFeatures - 1`` = fully extended, ExtendedIsolationForest.scala:56-69)."""

    extension_level: Optional[int] = None

    def __post_init__(self):
        super().__post_init__()
        if self.extension_level is not None and (
            not isinstance(self.extension_level, int) or self.extension_level < 0
        ):
            raise ValueError(f"extensionLevel must be an int >= 0, got {self.extension_level}")

    def to_param_map(self) -> dict:
        out = super().to_param_map()
        if self.extension_level is not None:
            out["extensionLevel"] = int(self.extension_level)
        return out

    @classmethod
    def from_param_map(cls, param_map: dict) -> "ExtendedIsolationForestParams":
        base = IsolationForestParams.from_param_map(param_map)
        ext = param_map.get("extensionLevel")
        return cls(**dataclasses.asdict(base), extension_level=None if ext is None else int(ext))


@dataclass(frozen=True)
class ResolvedParams:
    """Fit-time counts (core/Utils.scala:12-17): the per-tree sample count
    and feature-subset size, and the data's totals."""

    num_samples: int
    num_features: int
    total_num_samples: int
    total_num_features: int


def resolve_params(
    params: IsolationForestParams, total_num_features: int, total_num_samples: int
) -> ResolvedParams:
    """Resolve maxSamples/maxFeatures to counts (SharedTrainLogic.scala:33-77):
    a value above 1.0 is an absolute count (floored), one at or below 1.0 a
    fraction of the total (floored). Requires ``num_features > 0`` and
    ``num_samples >= 2`` (the reference's ``maxSamples -> 1`` throw); the
    sample count is capped at the dataset size, since every tree takes
    exactly ``num_samples`` rows."""
    if total_num_features <= 0:
        raise ValueError(f"dataset has no features (totalNumFeatures={total_num_features})")
    if total_num_samples <= 0:
        raise ValueError(f"dataset is empty (totalNumSamples={total_num_samples})")
    if params.max_features > 1.0:
        num_features = int(math.floor(params.max_features))
    else:
        num_features = int(math.floor(params.max_features * total_num_features))
    if params.max_samples > 1.0:
        num_samples = int(math.floor(params.max_samples))
    else:
        num_samples = int(math.floor(params.max_samples * total_num_samples))
    if num_features <= 0:
        raise ValueError(
            f"resolved numFeatures must be > 0 (maxFeatures={params.max_features}, "
            f"totalNumFeatures={total_num_features})"
        )
    if num_features > total_num_features:
        raise ValueError(
            f"resolved numFeatures={num_features} exceeds totalNumFeatures={total_num_features}"
        )
    if num_samples < 2:
        raise ValueError(
            f"resolved numSamples must be >= 2 (maxSamples={params.max_samples}, "
            f"totalNumSamples={total_num_samples})"
        )
    return ResolvedParams(
        num_samples=min(num_samples, total_num_samples),
        num_features=num_features,
        total_num_samples=total_num_samples,
        total_num_features=total_num_features,
    )


def resolve_extension_level(extension_level: Optional[int], num_features: int) -> int:
    """The EIF extension level: unset -> ``num_features - 1`` (fully
    extended); a set value must satisfy ``0 <= extensionLevel <=
    num_features - 1`` (ExtendedIsolationForest.scala:56-69)."""
    max_level = num_features - 1
    if extension_level is None:
        return max_level
    if extension_level > max_level:
        raise ValueError(
            f"extensionLevel={extension_level} exceeds maximum {max_level} for {num_features} features"
        )
    return int(extension_level)
