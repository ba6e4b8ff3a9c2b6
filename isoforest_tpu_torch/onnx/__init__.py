from .checker import CheckError, check_model, reference_scores
from .converter import (
    ExtendedIsolationForestConverter,
    IsolationForestConverter,
    convert_and_save,
)
from . import proto, runtime

__all__ = [
    "CheckError",
    "ExtendedIsolationForestConverter",
    "IsolationForestConverter",
    "check_model",
    "convert_and_save",
    "proto",
    "reference_scores",
    "runtime",
]
