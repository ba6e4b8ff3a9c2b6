"""Hyper-parameters of the standard and extended forests, with the reference's names,
defaults and validators (``isoforest_tpu/utils/params.py``;
``core/IsolationForestParamsBase.scala:8-110``).

Scoring reads none of them; a loaded model keeps them so its metadata
round-trips.
"""

from __future__ import annotations

import dataclasses
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
