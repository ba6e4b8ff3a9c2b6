"""Device meshes and their collectives for tree- and row-parallel forests
(``isoforest_tpu/parallel/mesh.py``).

The reference grows one tree per Spark partition, gathered by a
``collect()``, and scores row partitions against a broadcast forest
(SURVEY.md §0). The JAX package maps that onto a 2-D ``(data, trees)`` device mesh;
the port keeps the mesh and its axes:

* axis ``"trees"``: each shard grows an equal slab of the trees, and the
  slabs are gathered (Spark's ``collect()``);
* axis ``"data"``: rows are sharded, the forest replicated (the
  ``broadcast``); the 2-D variant keeps the forest sharded over ``trees``
  and sums the shards' partial path lengths.

A :class:`Mesh` is a ``[data, trees]`` grid of ``torch.device`` entries, one
entry a shard, and the rank of the process that owns each. Logical shards on
one device are shards all the same: eight entries of ``cpu`` (the tests) or
of ``cuda:0`` (one card) pad, split and reduce as eight devices would.
Shards flatten in the row-major order of ``(data, trees)``: tree slab i and
row block i go to flat shard i.

Across processes (:func:`initialize_distributed`, then :func:`create_mesh`)
every rank contributes its local devices, in rank order, so a rank's shards
are contiguous in the flat order. The collectives below are the only place
ranks talk: :func:`gather_shards` and :func:`reduce_shards` loop over a
rank's local shards in shard order, then all-gather or all-reduce across
the ranks over ``torch.distributed``. The backend follows from the mesh:
NCCL where every rank has a card of its own, gloo otherwise (NCCL refuses
two ranks on one card), with CUDA tensors staged through the host, since
gloo has no CUDA all-gather. A collective that fails raises.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
TREES_AXIS = "trees"

_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}


def _normalize_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"a mesh holds 'cuda' or 'cpu' devices, got {dev}")
    return dev


class Mesh:
    """A ``[data, trees]`` grid of shards: ``devices`` (``torch.device``
    entries) and ``owners`` (the rank owning each entry), both ``[d, t]``
    numpy object/int arrays; ``rank`` is this process's rank; ``group`` the
    process group of a mesh that spans processes (None in one process);
    ``row_groups[i]`` the subgroup of the ranks owning shards of data row
    ``i`` when they are several (else None)."""

    def __init__(self, devices, owners, rank: int = 0, group=None, row_groups=None) -> None:
        self.devices = np.asarray(devices, dtype=object)
        self.owners = np.asarray(owners, dtype=np.int64)
        if self.devices.ndim != 2 or self.devices.shape != self.owners.shape:
            raise ValueError(f"devices and owners must be [data, trees] grids of one shape, got "
                             f"{self.devices.shape} and {self.owners.shape}")
        self.rank = int(rank)
        self.group = group
        self.row_groups = dict(row_groups or {})
        self.local_shards: List[int] = [i for i, r in enumerate(self.owners.flat) if r == self.rank]
        if not self.local_shards:
            raise ValueError(f"rank {self.rank} owns no shard of the mesh")

    @property
    def shape(self) -> dict:
        """``{"data": d, "trees": t}``, as ``jax.sharding.Mesh.shape``."""
        return {DATA_AXIS: int(self.devices.shape[0]), TREES_AXIS: int(self.devices.shape[1])}

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def flat_devices(self) -> List[torch.device]:
        return list(self.devices.flat)

    @property
    def first_device(self) -> torch.device:
        """The first local shard's device: where gathered results land."""
        return self.devices.flat[self.local_shards[0]]

    @property
    def distributed(self) -> bool:
        return self.group is not None

    @property
    def backend(self) -> Optional[str]:
        return str(dist.get_backend(self.group)) if self.group is not None else None

    @property
    def world_size(self) -> int:
        return dist.get_world_size(self.group) if self.group is not None else 1

    def __repr__(self) -> str:
        return (f"Mesh(shape={self.shape}, devices={[str(d) for d in self.flat_devices]}, "
                f"rank={self.rank}, backend={self.backend})")


def _factor(n: int, data_parallelism: Optional[int]) -> int:
    """The data-axis size: ``data_parallelism``, else the largest divisor
    of ``n`` up to its square root (8 -> 2 x 4, 1 -> 1 x 1)."""
    if data_parallelism is None:
        data_parallelism = 1
        for cand in range(int(np.sqrt(n)), 0, -1):
            if n % cand == 0:
                data_parallelism = cand
                break
    if data_parallelism < 1 or n % data_parallelism != 0:
        raise ValueError(f"{n} devices not divisible by data_parallelism={data_parallelism}")
    return data_parallelism


def create_mesh(devices: Optional[Sequence] = None, data_parallelism: Optional[int] = None) -> Mesh:
    """A ``(data, trees)`` mesh over ``devices`` (default: every local CUDA
    device; with no card this raises, and a caller that wants the CPU passes
    ``[torch.device("cpu")] * n``).

    ``data_parallelism`` fixes the ``data`` axis; by default the count
    factors as evenly as possible (8 -> 2 x 4; 1 -> 1 x 1). After
    :func:`initialize_distributed`, ``devices`` are this rank's own, every
    rank gives as many, and the mesh spans every rank's devices in rank
    order (a collective call: every rank makes it)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass devices=[torch.device('cpu')] * n "
                               "to build a mesh of logical shards on the CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    local = [_normalize_device(d) for d in devices]
    if not local:
        raise ValueError("a mesh needs at least one device")
    if not (dist.is_available() and dist.is_initialized()):
        d = _factor(len(local), data_parallelism)
        grid = np.empty(len(local), dtype=object)
        grid[:] = local
        return Mesh(grid.reshape(d, -1), np.zeros((d, len(local) // d), np.int64))

    group = dist.group.WORLD
    rank, world = dist.get_rank(), dist.get_world_size()
    if dist.get_backend(group) == "nccl":
        if any(dev.type != "cuda" for dev in local):
            raise ValueError("an NCCL mesh holds CUDA devices only")
        torch.cuda.set_device(local[0])
    gathered: list = [None] * world
    dist.all_gather_object(gathered, [str(dev) for dev in local], group=group)
    counts = {len(g) for g in gathered}
    if len(counts) != 1:
        raise ValueError(f"every rank must give the mesh as many devices, got {[len(g) for g in gathered]}")
    flat = [torch.device(s) for g in gathered for s in g]
    owners = np.repeat(np.arange(world), len(local))
    d = _factor(len(flat), data_parallelism)
    grid = np.empty(len(flat), dtype=object)
    grid[:] = flat
    owners = owners.reshape(d, -1)
    # one subgroup for each data row whose shards span ranks; new_group is
    # collective, so every rank creates every subgroup in the same order
    row_groups = {}
    for i in range(d):
        ranks = sorted({int(r) for r in owners[i]})
        if len(ranks) > 1:
            sub = dist.new_group(ranks)
            if rank in ranks:
                row_groups[i] = sub
    return Mesh(grid.reshape(d, -1), owners, rank=rank, group=group, row_groups=row_groups)


def _collective_view(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` where the mesh's backend reads it: a host copy for gloo."""
    return t.contiguous() if mesh.backend == "nccl" else t.detach().cpu().contiguous()


def gather_shards(mesh: Mesh, parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Every shard's tensor concatenated along dim 0 in shard order, on the
    mesh's first local device. ``parts``: this rank's local shards' tensors,
    in shard order, all of one shape. In one process a local concatenation;
    across processes one all-gather of the ranks' concatenations."""
    dev = mesh.first_device
    local = torch.cat([p.to(dev) for p in parts]) if len(parts) > 1 else parts[0].to(dev)
    if not mesh.distributed:
        return local
    view = _collective_view(mesh, local)
    world = mesh.world_size
    if mesh.backend == "nccl":
        out = torch.empty((world * view.shape[0],) + tuple(view.shape[1:]), dtype=view.dtype, device=view.device)
        dist.all_gather_into_tensor(out, view, group=mesh.group)
    else:
        pieces = [torch.empty_like(view) for _ in range(world)]
        dist.all_gather(pieces, view, group=mesh.group)
        out = torch.cat(pieces)
    return out.to(dev)


def reduce_local(parts: Sequence[torch.Tensor], op: str, device: torch.device) -> torch.Tensor:
    """The ``op`` (``"sum"``, ``"min"`` or ``"max"``) of ``parts``,
    elementwise, in a loop in their order, on ``device``."""
    if op not in _REDUCE_OPS:
        raise ValueError(f"op must be one of {sorted(_REDUCE_OPS)}, got {op!r}")
    acc = parts[0].to(device)
    for p in parts[1:]:
        p = p.to(device)
        acc = acc + p if op == "sum" else (torch.minimum(acc, p) if op == "min" else torch.maximum(acc, p))
    return acc


def reduce_shards(mesh: Mesh, parts: Sequence[torch.Tensor], op: str, group=None) -> torch.Tensor:
    """The ``op`` (``"sum"``, ``"min"`` or ``"max"``) of every shard's
    tensor, elementwise, on the mesh's first local device. ``parts``: this
    rank's local shards' tensors; they reduce in a loop in shard order
    (:func:`reduce_local`), then, across processes, by one all-reduce over
    ``group`` (default: the mesh's; a data row's subgroup is
    ``mesh.row_groups[i]``)."""
    acc = reduce_local(parts, op, mesh.first_device)
    dev = mesh.first_device
    if not mesh.distributed:
        return acc
    view = _collective_view(mesh, acc).clone()  # the all-reduce writes in place
    dist.all_reduce(view, op=_REDUCE_OPS[op], group=group if group is not None else mesh.group)
    return view.to(dev)


def _default_backend(num_processes: int) -> str:
    """NCCL where every local rank has a card of its own, gloo otherwise.
    The local rank count is ``LOCAL_WORLD_SIZE`` when the launcher sets it,
    else ``num_processes`` (one host)."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    if torch.cuda.is_available() and dist.is_nccl_available() and torch.cuda.device_count() >= local:
        return "nccl"
    return "gloo"


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    timeout_s: Optional[float] = None,
    retry_policy=None,
    clock: Callable[[], float] = time.monotonic,
    sleep: Callable[[float], None] = time.sleep,
    backend: Optional[str] = None,
) -> None:
    """Bring up ``torch.distributed`` for a mesh across processes; a no-op
    for ``num_processes`` <= 1.

    ``torch.distributed.init_process_group(backend,
    init_method=f"tcp://{coordinator_address}", world_size=num_processes,
    rank=process_id)`` runs under the port's retry (the JAX package's
    default policy: 3 attempts, backoff from 1 s capped at 30 s);
    ``timeout_s`` bounds the whole bring-up and each attempt's own timeout
    is what is left of it. Each attempt first consumes an injected
    ``fail_distributed_init`` failure, if one is armed. The events
    ``distributed.init_attempt``, ``distributed.init_ok`` and
    ``distributed.init_failed`` carry the JAX package's fields. When the
    attempts run out it raises
    :class:`~..resilience.retry.DistributedTimeoutError` with the attempt
    diagnostics. ``backend`` (default: NCCL where every local rank has a
    card of its own, else gloo) is never swapped for another on a failure.
    ``coordinator_address`` (rank 0's ``host:port``) and ``process_id`` are
    required: the port detects no cluster.
    """
    if num_processes is None or num_processes <= 1:
        return
    if coordinator_address is None or process_id is None:
        raise ValueError("a bring-up of several processes needs coordinator_address ('host:port') and "
                         "process_id (this process's rank)")
    from ..resilience import faults
    from ..resilience.retry import DistributedTimeoutError, RetryError, RetryPolicy, retry_call
    from ..telemetry.events import record_event

    policy = retry_policy or RetryPolicy(max_attempts=3, base_delay_s=1.0, max_delay_s=30.0)
    if timeout_s is not None and policy.deadline_s is None:
        policy = dataclasses.replace(policy, deadline_s=float(timeout_s))
    backend = backend or _default_backend(int(num_processes))
    start = clock()
    attempts = {"n": 0}

    def attempt() -> None:
        attempts["n"] += 1
        record_event("distributed.init_attempt", attempt=attempts["n"], coordinator=coordinator_address,
                     process_id=process_id, num_processes=num_processes)
        faults.take_distributed_init_failure()
        kwargs = {}
        if timeout_s is not None:
            remaining = max(1.0, float(timeout_s) - (clock() - start))
            kwargs["timeout"] = datetime.timedelta(seconds=remaining)
        dist.init_process_group(backend=backend, init_method=f"tcp://{coordinator_address}",
                                world_size=int(num_processes), rank=int(process_id), **kwargs)

    try:
        retry_call(attempt, policy=policy,
                   describe=f"distributed bring-up (coordinator {coordinator_address}, "
                            f"process {process_id}/{num_processes})",
                   clock=clock, sleep=sleep)
        record_event("distributed.init_ok", attempts=attempts["n"], coordinator=coordinator_address,
                     process_id=process_id)
    except RetryError as exc:
        record_event("distributed.init_failed", attempts=attempts["n"], coordinator=coordinator_address,
                     process_id=process_id, error=repr(exc))
        raise DistributedTimeoutError(
            f"multi-host runtime never came up: {exc}",
            elapsed_s=exc.elapsed_s,
            deadline_s=policy.deadline_s,
            diagnostics=(
                f"coordinator={coordinator_address}",
                f"process_id={process_id}",
                f"num_processes={num_processes}",
                f"attempts={exc.attempts}",
            ),
        ) from exc


__all__ = [
    "DATA_AXIS",
    "TREES_AXIS",
    "Mesh",
    "create_mesh",
    "gather_shards",
    "initialize_distributed",
    "reduce_local",
    "reduce_shards",
]
