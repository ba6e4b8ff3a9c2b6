"""The estimator and fitted models."""

from .extended import ExtendedIsolationForestModel
from .isolation_forest import IsolationForest, IsolationForestModel

__all__ = ["ExtendedIsolationForestModel", "IsolationForest", "IsolationForestModel"]
