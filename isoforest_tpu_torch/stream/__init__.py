"""Online anomaly detection over event-time streams, in the port
(``isoforest_tpu/stream``): sources of timestamped rows (:mod:`.sources`)
flow through :class:`StreamEngine` (:mod:`.engine`), which scores them with
bounded lag through the serving coalescer on the model's device, folds
sealed panes into the lifecycle manager's reservoir, and retrains, validates
and swaps on the window cadence.

    from isoforest_tpu_torch.stream import StreamConfig, StreamEngine, generator_source
    engine = StreamEngine(manager, StreamConfig(window_s=60.0, lateness_s=5.0))
    summary = engine.run(generator_source(batches))
"""

from .engine import StreamConfig, StreamEngine
from .sources import StreamBatch, generator_source, socket_source, tail_source

__all__ = [
    "StreamBatch",
    "StreamConfig",
    "StreamEngine",
    "generator_source",
    "socket_source",
    "tail_source",
]
