"""Online scoring service of the port (``isoforest_tpu/serving``): a real
``POST /score`` with dynamic micro-batch coalescing.

Concurrent requests coalesce into micro-batches sized to the warmed
buckets (:mod:`.coalescer`), score once through ``model.score`` on the
card, the port's kernels, and go back to their waiters (:mod:`.service`),
behind the telemetry HTTP daemon (:mod:`.http`) with the backpressure
ladder: 429 on queue overflow, 503 on a stale queue or a timeout, 500 on a
scoring error (a stalled flush under ``score_timeout_s`` among them).

    from isoforest_tpu_torch.serving import serve_model
    handle = serve_model("path/to/model", port=8080, warm_batch_sizes=(1, 64, 4096))
    ...  # POST /score on handle.url; handle.manager refits on drift
    handle.close()

A model with a drift baseline is served through a lifecycle
:class:`~isoforest_tpu_torch.lifecycle.ModelManager` (``lifecycle=True``,
the default): drift on served rows triggers a refit, and a validated
candidate is swapped in between flushes. ``lifecycle=False`` serves it bare.
"""

from .coalescer import (
    CoalescerClosedError,
    MicroBatchCoalescer,
    QueueFullError,
    QueueStaleError,
    RequestTimeoutError,
    ServingError,
)
from .http import SCORE_PATH, handle_score, mount, unmount
from .service import ScoringService, ServingConfig, ServingHandle, ShedError, serve_model

__all__ = [
    "SCORE_PATH",
    "CoalescerClosedError",
    "MicroBatchCoalescer",
    "QueueFullError",
    "QueueStaleError",
    "RequestTimeoutError",
    "ScoringService",
    "ServingConfig",
    "ServingError",
    "ServingHandle",
    "ShedError",
    "handle_score",
    "mount",
    "serve_model",
    "unmount",
]
