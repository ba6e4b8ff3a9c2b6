"""ScoringService: the online scoring path behind ``POST /score``
(``isoforest_tpu/serving/service.py``).

* Requests coalesce in a :class:`~.coalescer.MicroBatchCoalescer`, and each
  flush is one ``model.score`` on one model reference: the port's kernels
  (K1-K5, as ``auto`` resolves the bucket) on the model's device, then one
  copy of the flush's scores to the host. ``score_timeout_s`` arms the
  scoring watchdog: a stalled flush raises ``WatchdogTimeout`` (the port
  retries on no other kernel) and every waiter of that flush gets a typed
  500, never a hang.
* A flush larger than the largest warmed bucket streams through the
  executor in bucket-sized chunks; the scores are bitwise those of one
  call on the card.
* :meth:`ScoringService.prewarm` resolves the autotuner's winner for each
  bucket and builds the kernels and tables (``model.warmup``) before traffic
  arrives, inside ``warmup_scope`` and ``compile_scope("serving.prewarm")``;
  :func:`serve_model` then calls ``mark_steady``, so a live request that
  builds a kernel or a table counts as a steady compile.
* With ``manager=`` (a :class:`~..lifecycle.ModelManager`) each flush is
  one ``manager.score``: it scores on the generation the manager holds at
  that moment, names it on the answer, folds the drift monitor and the
  refit window, and may trigger a refit on the manager's thread; a swap
  lands between flushes, never inside one.

:func:`serve_model` is the one-call assembly: load, wrap a model that has a
drift baseline in a manager (``lifecycle=True``, the default), mount
``POST /score`` on the telemetry daemon, prewarm, mark steady.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..telemetry.events import record_event
from ..telemetry.spans import set_span_attrs
from ..utils.logging import logger
from .coalescer import MicroBatchCoalescer, ServingError


def _host(scores) -> np.ndarray:
    """A flush's scores as host numpy: one copy from the card."""
    if isinstance(scores, torch.Tensor):
        return scores.detach().cpu().numpy()
    return np.asarray(scores)


@dataclasses.dataclass
class ServingConfig:
    """Knobs of the coalescing policy and the backpressure ladder (the JAX
    package's). ``batch_rows`` should be a
    :func:`~isoforest_tpu_torch.ops.traversal.batch_bucket` size: flushes
    then land on the pre-warmed, autotuned buckets."""

    batch_rows: int = 1024
    linger_ms: float = 2.0
    max_queue_rows: int = 8192
    queue_deadline_ms: float = 2000.0
    request_timeout_s: float = 30.0
    score_timeout_s: Optional[float] = None
    # answered idempotency keys remembered per service (LRU): a retry that
    # replays one of them scores again without folding the monitor again
    idempotency_capacity: int = 4096
    # priority class for the shed rung: under overload, lower weights are
    # refused (typed 429 + Retry-After) before higher ones
    weight: float = 1.0


class ShedError(ServingError):
    """Admission refused by the shed rung: this tenant's weight class is
    browned out so higher-priority traffic keeps its latency (HTTP 429;
    ``Retry-After`` carries the recovery-window estimate)."""

    status = 429


class ScoringService:
    """One model's online scoring front: admission-controlled, coalesced.
    Construct with either ``manager`` (a lifecycle manager) or ``model``
    (bare). ``clock``/``start`` go to the coalescer (tests: a fake clock and
    the threadless :meth:`~.coalescer.MicroBatchCoalescer.pump`)."""

    def __init__(
        self,
        model=None,
        manager=None,
        config: Optional[ServingConfig] = None,
        clock: Callable[[], float] = time.monotonic,
        start: bool = True,
        model_id: Optional[str] = None,
    ) -> None:
        if (model is None) == (manager is None):
            raise ValueError("pass exactly one of model= or manager=")
        self._bare_model = model
        self.manager = manager
        self.model_id = None if model_id is None else str(model_id)
        self.config = config or ServingConfig()
        from ..ops.traversal import batch_bucket

        # the largest pre-warmed bucket: a larger flush streams through the
        # executor in chunks of this many rows; prewarm() raises it
        self._max_warm_bucket = batch_bucket(self.config.batch_rows)
        self.coalescer = MicroBatchCoalescer(
            self._score_batch,
            max_batch_rows=self.config.batch_rows,
            max_linger_s=self.config.linger_ms / 1e3,
            max_queue_rows=self.config.max_queue_rows,
            queue_deadline_s=self.config.queue_deadline_ms / 1e3,
            clock=clock,
            start=start,
        )
        # idempotency keys this service already answered (an LRU set); a key
        # lands here only after its scores were computed
        self._idempotency_lock = threading.Lock()
        self._idempotency_seen: "collections.OrderedDict[str, None]" = collections.OrderedDict()
        # brownout state: single attribute reads and writes
        self._shed = False
        self._shed_retry_after_s: Optional[float] = None
        # (subsample fraction or None, force q16) while the quality rung is
        # engaged; None at full fidelity
        self._quality: Optional[Tuple[Optional[float], bool]] = None
        # the sliced subforest and its own table cache, keyed by the source
        # forest's identity and the kept tree count
        self._subforest_cache: Optional[Tuple[int, int, object, dict]] = None
        self.started_unix_s = time.time()

    @property
    def model(self):
        """The current active model."""
        return self.manager.model if self.manager is not None else self._bare_model

    # ------------------------------------------------------------------ #
    # brownout knobs
    # ------------------------------------------------------------------ #

    @property
    def shed(self) -> bool:
        return self._shed

    def set_shed(self, active: bool, retry_after_s: Optional[float] = None) -> None:
        """Engage or lift the shed rung. While it is active every admission
        is refused with :class:`ShedError` (429) before the queue;
        ``retry_after_s`` becomes the response's ``Retry-After``."""
        self._shed_retry_after_s = retry_after_s if active else None
        self._shed = bool(active)

    def check_admission(self) -> None:
        """The admission gate ahead of the coalescer: raises
        :class:`ShedError` while this tenant is shed."""
        if self._shed:
            exc = ShedError(
                f"tenant {self.model_id or 'default'} "
                f"(weight={self.config.weight:g}) is shed by the overload "
                "autopilot; retry after the brownout lifts"
            )
            exc.retry_after_s = self._shed_retry_after_s
            raise exc

    @property
    def quality(self) -> Optional[dict]:
        """The active quality degradation, or None at full fidelity."""
        q = self._quality
        if q is None:
            return None
        return {"subsample_trees": q[0], "q16": q[1]}

    def set_quality(self, subsample_trees: Optional[float] = None, force_q16: bool = False) -> None:
        """Engage or lift the quality rung: score every later flush on the
        first ``subsample_trees`` fraction of the forest and/or the q16
        plane; no arguments restore full fidelity. Responses then carry a
        ``degraded`` field."""
        if subsample_trees is not None:
            f = float(subsample_trees)
            if not 0.0 < f <= 1.0:
                raise ValueError(f"subsample_trees must be in (0, 1], got {f:g}")
            subsample_trees = None if f == 1.0 else f
        if subsample_trees is None and not force_q16:
            self._quality = None
            self._subforest_cache = None
            return
        self._quality = (subsample_trees, bool(force_q16))

    def _degraded_forest(self, model, fraction: Optional[float]):
        """``(forest, table cache)`` of the brownout: the first ``fraction``
        of the trees (trees are i.i.d., so a prefix is an unbiased
        subsample, and ``score_matrix`` divides by the kept count), with a
        table cache of its own, so flushes do not rebuild its tables."""
        forest = model.forest
        if fraction is None:
            return forest, model._cache
        total = int(forest.num_trees)
        keep = max(1, int(total * fraction))
        if keep >= total:
            return forest, model._cache
        cache = self._subforest_cache
        if cache is not None and cache[0] == id(forest) and cache[1] == keep:
            return cache[2], cache[3]
        sub = type(forest)(*(leaf[:keep] for leaf in forest))
        self._subforest_cache = (id(forest), keep, sub, {})
        return sub, self._subforest_cache[3]

    def _chunk_kwargs(self, rows: int) -> dict:
        """A flush past the largest warmed bucket streams in bucket-sized chunks."""
        if rows > self._max_warm_bucket:
            return {"chunk_size": self._max_warm_bucket, "pipeline": True}
        return {}

    def _score_quality_degraded(self, X: np.ndarray) -> Tuple[np.ndarray, Optional[int]]:
        """One flush under the quality rung: ``score_matrix`` of a point-in-
        time model reference on the sliced subforest and/or the q16 plane,
        as ``(scores, generation)`` (None without a manager). It bypasses
        the manager's fold: degraded scores must not feed the drift
        baseline."""
        from ..ops.traversal import score_matrix
        from ..utils.validation import UNKNOWN_TOTAL_NUM_FEATURES

        fraction, force_q16 = self._quality or (None, False)
        manager = self.manager
        model = manager.model if manager is not None else self._bare_model
        generation = manager.generation if manager is not None else None
        forest, cache = self._degraded_forest(model, fraction)
        width = int(model.total_num_features)
        scores = score_matrix(
            forest,
            X,
            model.num_samples,
            strategy="q16" if force_q16 else "auto",
            expected_features=None if width == UNKNOWN_TOTAL_NUM_FEATURES else width,
            device=model.device,
            cache=cache,
            timeout_s=self.config.score_timeout_s,
            **self._chunk_kwargs(int(X.shape[0])),
        )
        set_span_attrs(model_id=self.model_id, generation=generation or 0, degraded="quality",
                       subsample_trees=fraction if fraction is not None else 1.0, q16=force_q16)
        return _host(scores), generation

    def _score_batch(self, X: np.ndarray) -> Tuple[np.ndarray, Optional[int]]:
        """One coalesced flush: a single scoring call on one model reference,
        its scores copied to the host once, as ``(scores, generation)``.
        Through a manager the flush also feeds the manager's monitor, and
        the generation is the one pinned with the model that scored, which
        the answers name (a read of ``manager.generation`` after the flush
        could name the next generation for this one's scores); without a
        manager it is None."""
        if self._quality is not None:
            return self._score_quality_degraded(X)
        timeout_s = self.config.score_timeout_s
        kwargs = self._chunk_kwargs(int(X.shape[0]))
        # name the model generation that served this flush on its span; with
        # a manager, the one its score call pinned
        if self.manager is not None:
            scores, generation = self.manager.score(X, timeout_s=timeout_s, return_generation=True, **kwargs)
            set_span_attrs(model_id=self.model_id, generation=generation)
            return _host(scores), generation
        set_span_attrs(model_id=self.model_id, generation=0)
        return _host(self._bare_model.score(X, timeout_s=timeout_s, **kwargs)), None

    def score(self, rows: np.ndarray) -> np.ndarray:
        """Blocking request-side score: enqueue, coalesce, hand back. Raises
        the coalescer's admission and timeout errors (429/503 on the wire)."""
        self.check_admission()
        pending = self.coalescer.submit(rows)
        return self.coalescer.result(pending, timeout_s=self.config.request_timeout_s)

    def predict(self, scores: np.ndarray) -> np.ndarray:
        """Labels of host scores, float64 host numpy (``model.predict``)."""
        return self.model.predict(torch.from_numpy(np.asarray(scores))).numpy()

    # ------------------------------------------------------------------ #
    # idempotent replay
    # ------------------------------------------------------------------ #

    def idempotency_seen(self, key: str) -> bool:
        """True when ``key`` was already answered by this service: the
        retried request takes :meth:`score_replay` and does not fold again."""
        with self._idempotency_lock:
            if key in self._idempotency_seen:
                self._idempotency_seen.move_to_end(key)
                return True
            return False

    def record_idempotency(self, key: Optional[str]) -> None:
        """Remember an answered key (bounded LRU), after scoring succeeded."""
        if not key:
            return
        with self._idempotency_lock:
            self._idempotency_seen[key] = None
            self._idempotency_seen.move_to_end(key)
            while len(self._idempotency_seen) > self.config.idempotency_capacity:
                self._idempotency_seen.popitem(last=False)

    def score_replay(self, rows: np.ndarray) -> Tuple[np.ndarray, Optional[int]]:
        """``(scores, generation)`` of a replayed idempotent request, scored
        directly on the active model without folding the monitor: the first
        attempt already counted these rows."""
        rows = np.asarray(rows, np.float32)
        timeout_s = self.config.score_timeout_s
        kwargs = self._chunk_kwargs(int(rows.shape[0]))
        if self.manager is not None:
            scores, generation = self.manager.score(rows, timeout_s=timeout_s, return_generation=True, fold=False,
                                                    **kwargs)
            return _host(scores), generation
        return _host(self._bare_model.score(rows, timeout_s=timeout_s, fold_monitor=False, **kwargs)), None

    # ------------------------------------------------------------------ #

    def prewarm(self, batch_sizes: Sequence[int] = ()) -> List[dict]:
        """Resolve the autotuner's winner and build the kernels and tables of
        each batch bucket before traffic arrives, so no live flush pays a
        probe or a build. Emits one ``serving.warmup`` event naming the
        buckets and their strategies; returns the per-bucket decisions."""
        from .. import tuning
        from ..ops.traversal import batch_bucket
        from ..telemetry import resources

        model = self.model
        sizes = set(int(b) for b in batch_sizes)
        sizes.add(self.config.batch_rows)
        buckets = sorted({batch_bucket(b) for b in sizes if b >= 1})
        width = max(int(model.total_num_features), 1)
        decisions = []
        # prewarm is the warm-up phase: its builds attribute to
        # serving.prewarm and count as warmup even after mark_steady()
        with resources.warmup_scope(), resources.compile_scope(
            "serving.prewarm", key=",".join(str(b) for b in buckets)
        ):
            for bucket in buckets:
                dummy = np.zeros((bucket, width), np.float32)
                d = tuning.resolve_decision(model.forest, dummy, model.num_samples, device=model.device,
                                            cache=model._cache, site="serving.prewarm")
                decisions.append({"bucket": bucket, "strategy": d.strategy, "source": d.source, "key": d.key})
            model.warmup(batch_sizes=buckets, width=width)
        if buckets:
            self._max_warm_bucket = max(buckets)
        record_event(
            "serving.warmup",
            buckets=",".join(str(b) for b in buckets),
            strategies=json.dumps({str(d["bucket"]): d["strategy"] for d in decisions}, sort_keys=True),
        )
        logger.info("serving: pre-warmed %d batch bucket(s): %s", len(buckets),
                    ", ".join(f"{d['bucket']}->{d['strategy']}" for d in decisions))
        return decisions

    def state(self) -> dict:
        """Operator-facing service state (plain JSON types), merged into
        ``/healthz``."""
        return {
            "model_id": self.model_id,
            # the live coalescer policy, not the construction-time config
            "batch_rows": self.coalescer.max_batch_rows,
            "linger_ms": self.coalescer.max_linger_s * 1e3,
            "max_queue_rows": self.config.max_queue_rows,
            "queue_deadline_ms": self.config.queue_deadline_ms,
            "queue_rows": self.coalescer.pending_rows,
            "generation": self.manager.generation if self.manager is not None else None,
            "lifecycle": self.manager is not None,
            "weight": self.config.weight,
            "shed": self._shed,
            "quality": self.quality,
        }

    def close(self) -> None:
        """Drain the coalescer; a manager is left to its owner."""
        self.coalescer.close(drain=True)


class ServingHandle:
    """A running ``/score`` deployment: HTTP server and service (and a
    manager). ``close()`` tears it down in dependency order; a context
    manager."""

    def __init__(self, server, service: ScoringService, manager=None) -> None:
        self.server = server
        self.service = service
        self.manager = manager

    @property
    def url(self) -> str:
        return self.server.url

    def __enter__(self) -> "ServingHandle":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        self.service.close()
        if self.manager is not None:
            self.manager.close()
        self.server.stop()


def serve_model(
    model_dir: str,
    *,
    port: int = 0,
    host: str = "127.0.0.1",
    config: Optional[ServingConfig] = None,
    lifecycle: bool = True,
    work_dir: Optional[str] = None,
    warm_batch_sizes: Sequence[int] = (1,),
    manager_kwargs: Optional[dict] = None,
    device=None,
) -> ServingHandle:
    """Assemble the online scoring stack over a saved model directory:

    1. load the model onto ``device`` (default: the card), class-dispatched;
    2. with ``lifecycle=True`` and a model that carries a drift baseline,
       wrap it in a :class:`~..lifecycle.ModelManager` on that device
       (``work_dir``, default ``model_dir + ".lifecycle"``, and
       ``manager_kwargs``), which serves the generation ``CURRENT.json``
       there names, if any: a restarted process picks up the last swap. A
       model without a baseline warns and serves bare;
    3. start the telemetry HTTP server and mount ``POST /score`` on it;
    4. pre-warm the serving buckets, then mark the process steady.

    Returns the :class:`ServingHandle`.
    """
    from ..io.persistence import load_model
    from ..telemetry.http import serve as _telemetry_serve
    from ..telemetry.resources import mark_steady
    from .http import mount

    config = config or ServingConfig()
    model = load_model(model_dir, device=device)
    manager = None
    if lifecycle and model.baseline is not None:
        from ..lifecycle import ModelManager

        manager = ModelManager(model, work_dir=work_dir or model_dir + ".lifecycle", **(manager_kwargs or {}))
    elif lifecycle:
        logger.warning(
            "serving: %s has no _BASELINE.json sidecar — serving WITHOUT "
            "the lifecycle manager (no drift-triggered retraining); refit "
            "and re-save to enable it",
            model_dir,
        )
    service = ScoringService(model=None if manager is not None else model, manager=manager, config=config)
    server = _telemetry_serve(port=port, host=host)
    try:
        mount(server, service)
        service.prewarm(warm_batch_sizes)
    except BaseException:
        service.close()
        if manager is not None:
            manager.close()
        server.stop()
        raise
    # the warmed buckets are built: a build a live request pays for from here
    # on ticks isoforest_compiles_total{phase="steady"}
    mark_steady()
    record_event("serving.start", port=server.port, model=model_dir,
                 generation=manager.generation if manager is not None else 0, lifecycle=manager is not None)
    return ServingHandle(server, service, manager)
