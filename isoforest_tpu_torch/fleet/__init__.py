"""Multi-tenant model fleet of the port (``isoforest_tpu/fleet``): a
registry of lazily loaded tenants with a byte-budgeted residency LRU
(:mod:`.registry`), and per-tenant serving behind one port,
``POST /score/<model_id>`` and ``GET /models`` (:mod:`.service`).

    from isoforest_tpu_torch.fleet import serve_fleet
    handle = serve_fleet("models/", port=8080, budget_bytes=256 << 20)
    ...  # POST /score/<model_id> on handle.url
    handle.close()

On the card the budget counts the bytes each tenant holds there (its
forest and kernel tables); on the CPU the JAX package's count.
"""

from .registry import (
    EVICT_BUDGET,
    EVICT_CLOSE,
    EVICT_EXPLICIT,
    EVICT_FAULT,
    ManagedEntry,
    ModelLoadError,
    ModelRegistry,
    UnknownModelError,
    held_nbytes,
    layout_nbytes,
)
from .service import (
    MODELS_PATH,
    SCORE_PREFIX,
    FleetHandle,
    FleetService,
    discover_models,
    mount_fleet,
    serve_fleet,
    unmount_fleet,
)

__all__ = [
    "EVICT_BUDGET",
    "EVICT_CLOSE",
    "EVICT_EXPLICIT",
    "EVICT_FAULT",
    "FleetHandle",
    "FleetService",
    "MODELS_PATH",
    "ManagedEntry",
    "ModelLoadError",
    "ModelRegistry",
    "SCORE_PREFIX",
    "UnknownModelError",
    "discover_models",
    "held_nbytes",
    "layout_nbytes",
    "mount_fleet",
    "serve_fleet",
    "unmount_fleet",
]
