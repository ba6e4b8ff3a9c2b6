"""The replicated serving tier of the port (``isoforest_tpu/replication``).

A stdlib router fronting K serving replicas over one sealed models
directory: least-outstanding balancing, health-probe admission, idempotent
retries across replica death, drains and rolling model pushes with no
failed request. Entry points:

* :func:`serve_router` / :class:`RouterHandle`: the whole tier in one call
  (the ``python -m isoforest_tpu_torch route`` subcommand), each replica a
  ``python -m isoforest_tpu_torch serve`` process;
* :class:`Router` / :class:`Replica` / :class:`RouterConfig`: the pieces,
  driven in one process in the tests.
"""

from .router import (
    REPLICAS_PATH,
    NoReplicaError,
    Replica,
    ReplicaRequestError,
    Router,
    RouterConfig,
    RouterHandle,
    mount_router,
    serve_router,
    spawn_replica,
    unmount_router,
)

__all__ = [
    "REPLICAS_PATH",
    "NoReplicaError",
    "Replica",
    "ReplicaRequestError",
    "Router",
    "RouterConfig",
    "RouterHandle",
    "mount_router",
    "serve_router",
    "spawn_replica",
    "unmount_router",
]
