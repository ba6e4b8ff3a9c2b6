"""Fitted models."""

from .extended import ExtendedIsolationForestModel
from .isolation_forest import IsolationForestModel

__all__ = ["ExtendedIsolationForestModel", "IsolationForestModel"]
