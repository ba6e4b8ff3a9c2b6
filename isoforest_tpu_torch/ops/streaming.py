"""Streaming micro-batch executor (``isoforest_tpu/ops/streaming.py``):
rows reach the kernels chunk by chunk, and a host matrix is copied to the
card through two pinned buffers while the previous chunk computes.

* **Chunking.** ``X`` splits into ``chunk_rows`` micro-batches
  (:func:`resolve_chunk_rows`: explicit > ``ISOFOREST_TPU_PIPELINE_CHUNK`` >
  :data:`PLATFORM_DEFAULT_CHUNK`, measured on the card). The port compiles
  nothing per shape, so chunks are not rounded to the JAX package's
  power-of-two buckets and the ragged tail is not padded.
* **Staging.** Chunk *k* of a host ``X`` is packed into pinned host buffer
  *k % 2*, copied into device chunk buffer *k % 2* with
  ``copy_(non_blocking=True)`` on a side copy stream, and the kernel runs on
  the caller's current stream after a ``wait_event`` on that copy. The host
  packs chunk *k+1* while chunk *k* copies and computes.
* **Hazards.** (1) A pinned buffer is repacked only after the host waited on
  the event of the last copy out of it; the event travels with the cached
  buffer, so this holds across calls, which return without a
  synchronisation. (2) The copy stream waits on the event recorded after
  the kernel that last read a device chunk buffer before overwriting it.
  (3) Pinned allocation costs milliseconds, so buffers are cached per
  (device, chunk rows, width). (4) An execution holds its buffers under a
  lock; a caller that finds them held (a run the watchdog abandoned that
  woke up, or a concurrent caller) gets a private pair for that call.
* **Results.** Each chunk's path lengths go into one preallocated device
  ``f32[N]``; nothing is fetched to the host (the JAX package's lag-1 fetch
  becomes an event per chunk). ``score_matrix`` applies ``exp2`` once over
  all N, so chunking stays bitwise neutral: every kernel is row-independent.
* **NaN/inf.** Under ``nonfinite="warn"``/``"raise"`` each chunk's count of
  non-finite values is added into one device scalar, read once at the end
  of the execution; a raise comes before any score is returned.
* **Watchdog.** ``timeout_s`` runs the execution under
  :func:`~isoforest_tpu_torch.resilience.watchdog.run_with_deadline` on the
  caller's captured stream and device; a stall raises
  :class:`~isoforest_tpu_torch.resilience.watchdog.WatchdogTimeout`.

A CUDA-resident ``X`` is chunked without staging. On the CPU the executor
runs the same schedule with plain host buffers. When staging is unavailable
(no pinned memory or copy stream, or the ``break_pipeline_stage`` fault) a
streamed call takes the ``pipeline_fallback`` rung once and copies each chunk
synchronously: scores stay bitwise equal, only the overlap is lost.

Telemetry: ``isoforest_pipeline_chunks_total{site}``,
``isoforest_pipeline_h2d_seconds{site}`` (host-blocking staging seconds per
streamed execution: waits on a buffer's last copy, packs, enqueues),
``isoforest_pipeline_overlap_efficiency{site}`` (1 - that / the execution's
host wall time), one ``pipeline.run`` event per streamed execution and one
``pipeline.chunk`` span per chunk.
"""

from __future__ import annotations

import collections
import os
import threading
import time
from typing import Callable, Optional

import torch

from ..resilience import faults
from ..resilience.degradation import degrade
from ..telemetry import _state as _telemetry_state
from ..telemetry import resources as _resources
from ..telemetry.events import record_event
from ..telemetry.metrics import counter as _telemetry_counter
from ..telemetry.metrics import gauge as _telemetry_gauge
from ..telemetry.metrics import histogram as _telemetry_histogram
from ..telemetry.spans import span as _span
from ..utils.validation import check_nonfinite_policy, count_non_finite, report_non_finite

# Rows per chunk by device type. cuda: from the chunk sweep of
# chip_smoke.py's streaming phase on the H100 (PERF.md): 2^18 and 2^19 tie
# summed over the four (fixture, strategy) pairs, 2^17 pays more per chunk
# than it overlaps, and 2^20 is one chunk with nothing to overlap; 2^19
# keeps the standard walk's bulk launch that stages its records (>= 270,336
# rows). cpu: the JAX package's.
PLATFORM_DEFAULT_CHUNK = {"cuda": 1 << 19, "cpu": 1 << 18}

CHUNK_ENV = "ISOFOREST_TPU_PIPELINE_CHUNK"
PIPELINE_ENV = "ISOFOREST_TPU_PIPELINE"

_PIPELINE_CHUNKS = _telemetry_counter(
    "isoforest_pipeline_chunks_total",
    "Micro-batches executed by the streaming executor, by call site",
    labelnames=("site",),
)
_PIPELINE_H2D = _telemetry_histogram(
    "isoforest_pipeline_h2d_seconds",
    "Host-blocking host->device staging seconds per streamed execution",
    labelnames=("site",),
)
_PIPELINE_OVERLAP = _telemetry_gauge(
    "isoforest_pipeline_overlap_efficiency",
    "1 - (blocking staging seconds / streamed-run wall-clock) of the last "
    "streamed execution per site: ~1.0 when staging hides under compute",
    labelnames=("site",),
)


def pipeline_enabled(override: Optional[bool] = None) -> bool:
    """``ISOFOREST_TPU_PIPELINE`` gate (default on); an explicit
    ``pipeline=`` argument wins over the environment."""
    if override is not None:
        return bool(override)
    return os.environ.get(PIPELINE_ENV, "1").strip().lower() not in ("0", "false", "off", "no")


def default_chunk_rows(platform: str = "cuda") -> int:
    """``ISOFOREST_TPU_PIPELINE_CHUNK``, else the platform's measured default."""
    env = os.environ.get(CHUNK_ENV)
    if env:
        try:
            return max(1, int(env))
        except ValueError:
            pass
    return PLATFORM_DEFAULT_CHUNK.get(platform, 1 << 18)


def resolve_chunk_rows(chunk_rows: Optional[int] = None, platform: str = "cuda", multiple: int = 1) -> int:
    """The executor's chunk policy: explicit ``chunk_rows`` > the environment
    > the platform's default, rounded down to a ``multiple`` (a mesh's shard
    count: sharded scoring splits each chunk over the shards), and at least
    one ``multiple``."""
    rows = chunk_rows if chunk_rows is not None else default_chunk_rows(platform)
    if rows < 1:
        raise ValueError(f"chunk_rows must be >= 1, got {rows}")
    return max(int(multiple), int(rows) - int(rows) % int(multiple))


# device -> probed availability of pinned memory and a copy stream; the
# break_pipeline_stage fault is consulted before the cache
_STAGE_PROBED: dict = {}


def stage_available(device) -> bool:
    """Whether the executor can stage onto ``device``: on the CPU always, on
    the card when pinned host memory and a side stream can be made (probed
    once per device). The ``break_pipeline_stage`` fault forces False."""
    if faults.active("break_pipeline_stage"):
        return False
    device = torch.device(device)
    if device.type != "cuda":
        return True
    hit = _STAGE_PROBED.get(str(device))
    if hit is None:
        try:
            torch.empty(1, pin_memory=True)
            torch.cuda.Stream(device)
            hit = True
        except RuntimeError:
            hit = False
        _STAGE_PROBED[str(device)] = hit
    return hit


class _Staging:
    """Two host buffers (pinned on the card) and two device chunk buffers,
    with the events that order their reuse (module docstring, hazards 1-2)."""

    def __init__(self, device: torch.device, rows: int, width: int) -> None:
        cuda = device.type == "cuda"
        self.host = [torch.empty((rows, width), dtype=torch.float32, pin_memory=cuda) for _ in range(2)]
        self.dev = [torch.empty((rows, width), dtype=torch.float32, device=device) for _ in range(2)]
        self.lock = threading.Lock()
        self.copy_stream = torch.cuda.Stream(device) if cuda else None
        self.copied = [torch.cuda.Event() for _ in range(2)] if cuda else None
        self.consumed = [torch.cuda.Event() for _ in range(2)] if cuda else None

    def stage(self, slot: int, rows: torch.Tensor, stream) -> torch.Tensor:
        """Pack ``rows`` into host buffer ``slot``, copy it into device
        buffer ``slot`` and make ``stream`` wait for the copy; the device
        rows, ``[len(rows), F]``."""
        n = rows.shape[0]
        host, dev = self.host[slot][:n], self.dev[slot][:n]
        if self.copy_stream is None:
            host.copy_(rows)
            dev.copy_(host)
            return dev
        self.copied[slot].synchronize()  # hazard 1: the last copy out of this buffer is done
        host.copy_(rows)
        self.copy_stream.wait_event(self.consumed[slot])  # hazard 2: its last reader has run
        with torch.cuda.stream(self.copy_stream):
            dev.copy_(host, non_blocking=True)
        self.copied[slot].record(self.copy_stream)
        stream.wait_event(self.copied[slot])
        return dev

    def read_by(self, slot: int, stream) -> None:
        """Mark device buffer ``slot`` as read by the work queued on ``stream``."""
        if self.consumed is not None:
            self.consumed[slot].record(stream)

    def quiesce(self) -> None:
        """Wait for every copy and every reader of these buffers."""
        for event in (self.copied or []) + (self.consumed or []):
            event.synchronize()


# (device, chunk rows, width) -> _Staging, least recently used first
_STAGING: "collections.OrderedDict[tuple, _Staging]" = collections.OrderedDict()
_STAGING_MAX = 4
_STAGING_LOCK = threading.Lock()


def _acquire_staging(device: torch.device, rows: int, width: int):
    """``(staging, cached)``: the cached pair for this shape, held for the
    execution, or a private pair when another execution holds it (hazard 4)."""
    key = (str(device), rows, width)
    with _STAGING_LOCK:
        entry = _STAGING.get(key)
        if entry is None:
            entry = _STAGING[key] = _Staging(device, rows, width)
            for old_key in list(_STAGING)[: max(0, len(_STAGING) - _STAGING_MAX)]:
                old = _STAGING[old_key]
                if old.lock.acquire(blocking=False):  # evict only what no execution holds
                    del _STAGING[old_key]
                    old.quiesce()
                    old.lock.release()
        else:
            _STAGING.move_to_end(key)
        if entry.lock.acquire(blocking=False):
            return entry, True
    return _Staging(device, rows, width), False


class StreamingExecutor:
    """Chunking, staging, the non-finite count and the watchdog of one
    scoring call (module docstring).

    ``run_chunk(chunk)`` returns the ``f32[rows]`` path lengths of one
    ``[rows, F]`` chunk on ``device``, launched on the current stream.
    ``execute(X)`` returns all N in one device tensor without a
    synchronisation (but the non-finite count's read). ``prelude`` runs
    inside the watchdog's scope before the first chunk (the
    ``slow_collective`` seam). With ``nonfinite_counts`` (a list), each
    execution appends its device count of non-finite values to it, unread,
    instead of reporting it under ``nonfinite``: the caller reports the
    total of several executions once (sharded scoring).
    """

    def __init__(
        self,
        run_chunk: Callable[[torch.Tensor], torch.Tensor],
        chunk_rows: int,
        *,
        device,
        site: str = "score_matrix",
        streaming: bool = True,
        timeout_s: Optional[float] = None,
        describe: str = "streamed scoring",
        prelude: Optional[Callable[[], None]] = None,
        nonfinite: str = "allow",
        nonfinite_counts: Optional[list] = None,
    ) -> None:
        if chunk_rows < 1:
            raise ValueError(f"chunk_rows must be >= 1, got {chunk_rows}")
        check_nonfinite_policy(nonfinite)
        self._run_chunk = run_chunk
        self.chunk_rows = int(chunk_rows)
        self.device = torch.device(device)
        self._site = site
        self._streaming = streaming
        self._timeout_s = timeout_s
        self._describe = describe
        self._prelude = prelude
        self._nonfinite = nonfinite
        self._nonfinite_counts = nonfinite_counts

    def execute(self, X: torch.Tensor) -> torch.Tensor:
        """Path lengths of every row of ``X`` (on the host or on
        ``device``), ``f32[N]`` on ``device``; under ``timeout_s`` in a
        watchdog worker that runs on the caller's stream and device."""
        n = int(X.shape[0])
        if n == 0:
            return torch.zeros(0, dtype=torch.float32, device=self.device)
        if self._timeout_s is None:
            return self._run(X, n)
        from ..resilience.watchdog import run_with_deadline

        if self.device.type == "cuda":
            stream = torch.cuda.current_stream(self.device)

            def work():
                with torch.cuda.device(self.device), torch.cuda.stream(stream):
                    return self._run(X, n)
        else:
            def work():
                return self._run(X, n)
        return run_with_deadline(work, self._timeout_s, describe=self._describe)

    def _run(self, X: torch.Tensor, n: int) -> torch.Tensor:
        if self._prelude is not None:
            self._prelude()
        check = self._nonfinite != "allow"
        # the executor is the one dispatch seam of every chunked scoring
        # path, so a kernel build its launches trigger attributes here by
        # default; semantic callers (serving.prewarm, autotune probes) open
        # an outer scope and win the attribution
        with _resources.compile_scope(self._site, key=f"rows={min(n, self.chunk_rows)}"):
            if n <= self.chunk_rows:
                # one chunk: nothing to overlap
                xc = X if X.device == self.device else X.to(self.device)
                if _telemetry_state.enabled():
                    _PIPELINE_CHUNKS.inc(1, site=self._site)
                out = self._run_chunk(xc)
                bad = count_non_finite(xc) if check else None
            else:
                out, bad = self._run_streamed(X, n, check)
        if bad is not None and self._nonfinite_counts is not None:
            self._nonfinite_counts.append(bad)
        elif bad is not None:
            report_non_finite(int(bad), self._nonfinite)
        return out

    def _run_streamed(self, X: torch.Tensor, n: int, check: bool):
        chunk, dev = self.chunk_rows, self.device
        committed = self._streaming and stage_available(dev)
        if self._streaming and not committed:
            # strict-exempt: the synchronous copies give bitwise-equal scores
            degrade("pipeline_fallback", "pipeline", "sync_copy",
                    detail="staging is unavailable (no pinned memory or copy stream, or fault-injected away); "
                           "chunks copy synchronously: no overlap, scores unchanged")
        host = X.device.type == "cpu"
        stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
        out = torch.empty(n, dtype=torch.float32, device=dev)
        bad = torch.zeros((), dtype=torch.int64, device=dev) if check else None
        staging, cached = _acquire_staging(dev, chunk, int(X.shape[1])) if host and committed else (None, False)
        if staging is not None:
            # both host buffers, live for the run: the resource plane's watermark
            _resources.note_host_staging(self._site, 2 * chunk * int(X.shape[1]) * 4)
        t_start = time.perf_counter()
        h2d_s = 0.0
        n_chunks = 0
        try:
            for start in range(0, n, chunk):
                stop = min(start + chunk, n)
                slot = n_chunks % 2
                with _span("pipeline.chunk", site=self._site, index=n_chunks, rows=stop - start) as csp:
                    t0 = time.perf_counter()
                    if staging is not None:
                        xc = staging.stage(slot, X[start:stop], stream)
                    else:
                        xc = X[start:stop].to(dev)  # resident rows: a view; else a synchronous copy
                    chunk_h2d = time.perf_counter() - t0
                    h2d_s += chunk_h2d
                    t1 = time.perf_counter()
                    if bad is not None:
                        bad += count_non_finite(xc)
                    out[start:stop].copy_(self._run_chunk(xc))
                    if staging is not None:
                        staging.read_by(slot, stream)
                    csp.set_attrs(h2d_s=round(chunk_h2d, 6), compute_dispatch_s=round(time.perf_counter() - t1, 6))
                n_chunks += 1
        finally:
            if cached:
                staging.lock.release()
        total_s = max(time.perf_counter() - t_start, 1e-9)
        if _telemetry_state.enabled():
            eff = max(0.0, min(1.0, 1.0 - h2d_s / total_s))
            _PIPELINE_CHUNKS.inc(n_chunks, site=self._site)
            _PIPELINE_H2D.observe(h2d_s, site=self._site)
            _PIPELINE_OVERLAP.set(eff, site=self._site)
            record_event("pipeline.run", site=self._site, chunks=n_chunks, rows=n, h2d_s=round(h2d_s, 6),
                         overlap_efficiency=round(eff, 4), fallback=not committed, staged=staging is not None)
        return out, bad


def pipeline_stats(site: str = "score_matrix") -> dict:
    """Pipeline telemetry of one call site (``h2d_seconds``: the cumulative
    blocking staging time across streamed executions)."""
    return {
        "chunks": int(_PIPELINE_CHUNKS.value(site=site)),
        "h2d_seconds": round(float(_PIPELINE_H2D.summary(site=site)["sum"]), 6),
        "overlap_efficiency": round(float(_PIPELINE_OVERLAP.value(site=site)), 4),
    }


__all__ = [
    "PLATFORM_DEFAULT_CHUNK",
    "StreamingExecutor",
    "default_chunk_rows",
    "pipeline_enabled",
    "pipeline_stats",
    "resolve_chunk_rows",
    "stage_available",
]
