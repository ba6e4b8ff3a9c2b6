"""isoforest_tpu_torch: the isolation forest of ``isoforest_tpu`` in PyTorch,
with hand-written CUDA kernels for NVIDIA Hopper (H100).

This first slice serves standard forests: load a model the JAX package (or
the reference) saved, and score rows on the card through the O(h) walk
kernel (``csrc/walk.cu``) or the dense level-walk kernel
(``csrc/dense.cu``). Entry points run on the card unless the caller names
another device; ``device="cpu"`` runs the kernels' plain PyTorch versions.

    from isoforest_tpu_torch import load_model
    scores = load_model("path/to/model").score(X)
"""

from .models import IsolationForestModel
from .ops.traversal import score_matrix


def load_model(path: str, device=None, require_success: bool = True) -> IsolationForestModel:
    """Load a standard model directory onto ``device`` (default: the card)."""
    return IsolationForestModel.load(path, device=device, require_success=require_success)


__all__ = ["IsolationForestModel", "load_model", "score_matrix"]
