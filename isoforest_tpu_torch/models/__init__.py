"""The estimators and fitted models."""

from .extended import ExtendedIsolationForest, ExtendedIsolationForestModel
from .isolation_forest import IsolationForest, IsolationForestModel

__all__ = ["ExtendedIsolationForest", "ExtendedIsolationForestModel", "IsolationForest", "IsolationForestModel"]
