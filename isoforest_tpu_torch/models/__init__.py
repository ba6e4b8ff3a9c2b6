"""Fitted models."""

from .isolation_forest import IsolationForestModel

__all__ = ["IsolationForestModel"]
