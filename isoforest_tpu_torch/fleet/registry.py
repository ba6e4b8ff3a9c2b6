"""Model fleet registry: many tenants, one process, budgeted residency
(``isoforest_tpu/fleet/registry.py``).

:class:`ModelRegistry` maps ``model_id`` to a lazily loaded per-tenant
stack: the model on its device, a lifecycle
:class:`~isoforest_tpu_torch.lifecycle.ModelManager` (which resumes the
last swapped generation from ``work_dir/CURRENT.json``) and a
:class:`~isoforest_tpu_torch.serving.ScoringService` with its own
coalescer, admission queue and backpressure. One tenant's 429/503, drift
debounce, refit or hot swap never perturbs another's.

* **Registration is cheap.** ``register(model_id, model_dir)`` records the
  sealed directory and the tenant's serving knobs; nothing loads. The
  directories stay authoritative: residency is a cache.
* **Residency is byte-budgeted LRU.** Each resident tenant pins bytes; when
  a load pushes the fleet past ``budget_bytes``, the least recently used
  tenants are evicted (their coalescer drained first) until it fits. A
  tenant mid-refit is pinned: eviction is refused until the swap or the
  rollback completes.
* **What the budget counts.** On the CPU, the JAX package's count for the
  same model (:func:`layout_nbytes`: its packed layout, or its q16 plane),
  so eviction follows the JAX package's order. On the card, the bytes the
  tenant actually holds there once warmed (:func:`held_nbytes`: the forest
  and every kernel table in the model's cache, one entry per strategy
  ``auto`` built), recounted after each request, so the budget bounds card
  memory. The two differ (a q16 tenant keeps f32 tables on the card).
* **Everything is observable.** ``fleet.load`` / ``fleet.evict`` /
  ``fleet.evict_refused`` events, the
  ``isoforest_fleet_{resident_models,resident_bytes,loads_total,
  evictions_total}`` series, and two degradation rungs:
  ``fleet_load_failed`` (a broken tenant is refused with a typed 503, the
  rest of the fleet keeps serving) and ``fleet_evict_under_load`` (an
  eviction drained in-flight work; scores exact).

Lock discipline: the registry lock guards only the entry map and the
residency totals and never calls out while held; each entry's lock
serialises that tenant's load and evict transitions and may take the
registry lock, never another entry's. The scoring path holds neither: it
submits to a point-in-time service reference.
"""

from __future__ import annotations

import os
import re
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..resilience import faults
from ..resilience.degradation import degrade
from ..serving.coalescer import CoalescerClosedError, ServingError
from ..serving.service import ScoringService, ServingConfig
from ..telemetry import resources as _resources
from ..telemetry.events import record_event
from ..telemetry.metrics import counter as _counter, gauge as _gauge
from ..utils.logging import logger

_RESIDENT_MODELS = _gauge(
    "isoforest_fleet_resident_models",
    "Models currently resident (packed scoring layout in memory) in the "
    "fleet registry",
)
_RESIDENT_BYTES = _gauge(
    "isoforest_fleet_resident_bytes",
    "Packed scoring-layout bytes pinned by the resident fleet models "
    "(the quantity the residency budget bounds)",
)
_LOADS_TOTAL = _counter(
    "isoforest_fleet_loads_total",
    "Fleet model loads (first-request lazy loads and post-eviction "
    "re-loads), per tenant",
    labelnames=("model_id",),
)
_EVICTIONS_TOTAL = _counter(
    "isoforest_fleet_evictions_total",
    "Fleet residency evictions by cause "
    "(budget = LRU under byte pressure; explicit = operator/API call; "
    "fault_injected = the evict_during_score seam; close = shutdown)",
    labelnames=("cause",),
)

# eviction causes (the {cause=} label values)
EVICT_BUDGET = "budget"
EVICT_EXPLICIT = "explicit"
EVICT_FAULT = "fault_injected"
EVICT_CLOSE = "close"

# a model id is a URL path segment (POST /score/<model_id>) and a metric
# label value: keep it to a conservative, unescapable alphabet
_MODEL_ID_RE = re.compile(r"[A-Za-z0-9][A-Za-z0-9._-]{0,63}")


class UnknownModelError(ServingError):
    """No tenant registered under this model id (HTTP 404)."""

    status = 404


class ModelLoadError(ServingError):
    """The tenant's lazy (re)load failed; the registry will retry on its
    next request (HTTP 503 — retriable; other tenants are unaffected)."""

    status = 503
    # loads are retried on the very next request: a short, fixed backoff
    retry_after_s = 1.0


def layout_nbytes(model) -> int:
    """The JAX package's residency count for ``model``: the bytes of its
    finalized layout (f32: record, value plane and narrowed feature table),
    or of the q16 plane for a tenant that prefers it. The budget counts
    this on the CPU."""
    return int(_resources._layout_nbytes(model))


def held_nbytes(model) -> int:
    """Bytes ``model`` holds on its device: the forest's arrays and every
    kernel table in its cache (``(strategy, device)`` entries, built by
    ``scoring_tables`` and by ``auto``'s probes). The budget counts this on
    the card."""
    from ..ops.scoring_layout import layout_nbytes as _tables_nbytes

    forest = sum(int(a.numel()) * a.element_size() for a in model.forest if isinstance(a, torch.Tensor))
    tables = sum(_tables_nbytes(v) for k, v in list(model._cache.items())
                 if isinstance(k, tuple) and isinstance(v, tuple))
    return forest + tables


def _counts_held_tables(model) -> bool:
    """True where the budget counts :func:`held_nbytes`: a model on a CUDA
    device."""
    return model.device.type == "cuda"


class ManagedEntry:
    """One registered tenant: its sealed model dir (authoritative), its
    lifecycle work dir, its serving knobs, and — while resident — its
    loaded model, manager and per-tenant scoring service. The entry lock
    serialises load/evict transitions for this tenant only."""

    def __init__(
        self,
        model_id: str,
        model_dir: str,
        work_dir: str,
        config: ServingConfig,
        lifecycle: bool,
        manager_kwargs: dict,
    ) -> None:
        self.model_id = model_id
        self.model_dir = model_dir
        self.work_dir = work_dir
        self.config = config
        self.lifecycle = lifecycle
        self.manager_kwargs = manager_kwargs
        self._lock = threading.Lock()
        self.model = None
        self.manager = None
        self.service: Optional[ScoringService] = None
        self.resident_bytes = 0
        # host/device split of resident_bytes (telemetry.resources
        # .model_plane_bytes): placement='device' on accelerator backends
        self.plane_bytes: Optional[dict] = None
        self.loads = 0
        self.last_used = 0  # registry LRU sequence number
        self.last_load_error: Optional[str] = None

    @property
    def resident(self) -> bool:
        return self.service is not None

    @property
    def pinned(self) -> bool:
        """True while this tenant's manager is mid-retrain — eviction is
        refused until the swap/rollback completes."""
        manager = self.manager
        return manager is not None and manager.retrain_in_progress

    @property
    def generation(self) -> Optional[int]:
        manager = self.manager
        return manager.generation if manager is not None else None

    def state(self) -> dict:
        """Operator-facing tenant state (plain JSON types) — one row of
        ``GET /models`` and of the ``/healthz`` fleet section."""
        service = self.service
        manager = self.manager
        doc = {
            "model_id": self.model_id,
            "model_dir": self.model_dir,
            "resident": service is not None,
            "resident_bytes": self.resident_bytes,
            "plane_bytes": dict(self.plane_bytes) if self.plane_bytes else None,
            "loads": self.loads,
            "last_used_seq": self.last_used,
            "pinned": self.pinned,
            "lifecycle": manager is not None,
            "generation": self.generation,
            "queue_rows": service.coalescer.pending_rows if service else None,
            "retrain_in_progress": (
                manager.retrain_in_progress if manager is not None else False
            ),
            "last_load_error": self.last_load_error,
            # autopilot visibility: the tenant's shed
            # priority class and any active brownout state
            "weight": self.config.weight,
            "shed": service.shed if service is not None else False,
            "quality": service.quality if service is not None else None,
        }
        return doc


class ModelRegistry:
    """``model_id -> ManagedEntry`` with a byte-budgeted residency LRU
    (module docstring).

    ``budget_bytes=None`` disables eviction (every registered tenant may
    stay resident). ``config`` is the default per-tenant
    :class:`ServingConfig` (override per tenant at :meth:`register`);
    ``lifecycle``/``manager_kwargs`` likewise. ``clock`` is injectable for
    tests. Tenants load onto ``device`` (default: the card).
    """

    def __init__(
        self,
        *,
        budget_bytes: Optional[int] = None,
        config: Optional[ServingConfig] = None,
        lifecycle: bool = True,
        manager_kwargs: Optional[dict] = None,
        clock: Callable[[], float] = time.monotonic,
        device=None,
    ) -> None:
        if budget_bytes is not None and budget_bytes <= 0:
            raise ValueError(f"budget_bytes must be positive, got {budget_bytes}")
        self.budget_bytes = budget_bytes
        self.default_config = config or ServingConfig()
        self.default_lifecycle = bool(lifecycle)
        self.default_manager_kwargs = dict(manager_kwargs or {})
        self.closed = False
        self._clock = clock
        # where tenants load (None: the card)
        self.device = device
        # guards the entry map, the LRU sequence and the residency totals;
        # never held across a load/evict (those hold the entry lock and may
        # acquire THIS lock for accounting — entry -> registry, one way)
        self._lock = threading.Lock()
        self._entries: Dict[str, ManagedEntry] = {}
        self._seq = 0
        self._resident_bytes = 0

    # ------------------------------------------------------------------ #
    # registration / lookup
    # ------------------------------------------------------------------ #

    def register(
        self,
        model_id: str,
        model_dir: str,
        *,
        work_dir: Optional[str] = None,
        config: Optional[ServingConfig] = None,
        lifecycle: Optional[bool] = None,
        manager_kwargs: Optional[dict] = None,
    ) -> ManagedEntry:
        """Register a tenant over a sealed model directory. Nothing loads
        until the tenant's first request (or an explicit
        :meth:`ensure_resident`). Refuses duplicate ids and ids that do not
        fit the URL/label alphabet."""
        model_id = str(model_id)
        if not _MODEL_ID_RE.fullmatch(model_id):
            raise ValueError(
                f"model_id {model_id!r} must match {_MODEL_ID_RE.pattern} "
                "(it becomes a URL path segment and a metric label)"
            )
        if not os.path.isdir(model_dir):
            raise FileNotFoundError(
                f"model_dir {model_dir!r} for tenant {model_id!r} does not exist"
            )
        entry = ManagedEntry(
            model_id,
            str(model_dir),
            str(work_dir or model_dir + ".lifecycle"),
            config or self.default_config,
            self.default_lifecycle if lifecycle is None else bool(lifecycle),
            dict(
                self.default_manager_kwargs
                if manager_kwargs is None
                else manager_kwargs
            ),
        )
        with self._lock:
            if self.closed:
                raise RuntimeError("the registry is closed")
            if model_id in self._entries:
                raise ValueError(f"model_id {model_id!r} is already registered")
            self._entries[model_id] = entry
        record_event("fleet.register", model_id=model_id, path=entry.model_dir)
        return entry

    def entry(self, model_id: str) -> ManagedEntry:
        with self._lock:
            entry = self._entries.get(str(model_id))
        if entry is None:
            raise UnknownModelError(
                f"no model registered under id {str(model_id)!r}"
            )
        return entry

    def model_ids(self) -> List[str]:
        with self._lock:
            return sorted(self._entries)

    def models_state(self) -> List[dict]:
        """Per-tenant state rows (``GET /models``), registration order
        normalised to sorted ids."""
        with self._lock:
            entries = [self._entries[k] for k in sorted(self._entries)]
        return [e.state() for e in entries]

    def resident_services(self) -> List[ScoringService]:
        """Point-in-time references to every resident tenant's scoring
        service (the autopilot's sensor/actuator set).
        Safe to call from any thread; entries mid-eviction simply drop
        out of the snapshot."""
        with self._lock:
            entries = list(self._entries.values())
        return [e.service for e in entries if e.service is not None]

    def state(self) -> dict:
        """Fleet-level state (plain JSON types)."""
        with self._lock:
            total = len(self._entries)
            resident_bytes = self._resident_bytes
            resident = sum(1 for e in self._entries.values() if e.resident)
        return {
            "models": total,
            "resident_models": resident,
            "resident_bytes": resident_bytes,
            "budget_bytes": self.budget_bytes,
        }

    # ------------------------------------------------------------------ #
    # residency
    # ------------------------------------------------------------------ #

    def ensure_resident(self, model_id: str) -> ManagedEntry:
        """The tenant's entry with a live service, loading (and then
        enforcing the residency budget) if needed; touches the LRU."""
        entry = self.entry(model_id)
        loaded = False
        with entry._lock:
            if entry.service is None:
                self._load_entry_locked(entry)
                loaded = True
        with self._lock:
            self._seq += 1
            entry.last_used = self._seq
        if loaded:
            self._enforce_budget(exclude=entry.model_id)
        return entry

    def _load_entry_locked(self, entry: ManagedEntry) -> None:
        """Load one tenant (caller holds the entry lock): sealed dir ->
        model on the registry's device -> lifecycle manager (resuming the
        last swapped generation from CURRENT.json) -> per-tenant service;
        on the card the service is warmed, so the count is of the tables it
        serves from. Any failure takes the ``fleet_load_failed`` rung and
        refuses with a typed 503; the entry stays non-resident and the NEXT
        request retries: one broken tenant never poisons the fleet."""
        from ..io.persistence import load_model
        from ..lifecycle import ModelManager

        t0 = time.perf_counter()
        try:
            # a tenant's lazy first load (or post-eviction reload) is an
            # expected one-time cost: its builds attribute to fleet.load and
            # tick phase=warmup even after serving has marked steady
            with _resources.warmup_scope(), _resources.compile_scope(
                "fleet.load", key=entry.model_id
            ):
                faults.check_fleet_load(entry.model_id)
                model = load_model(entry.model_dir, device=self.device)
                manager = None
                if entry.lifecycle and model.baseline is not None:
                    manager = ModelManager(
                        model,
                        work_dir=entry.work_dir,
                        model_id=entry.model_id,
                        **entry.manager_kwargs,
                    )
                elif entry.lifecycle:
                    logger.warning(
                        "fleet: %s (%s) has no _BASELINE.json sidecar — "
                        "serving WITHOUT the lifecycle manager (no "
                        "drift-triggered retraining); refit and re-save to "
                        "enable it",
                        entry.model_id,
                        entry.model_dir,
                    )
                active = manager.model if manager is not None else model
                service = ScoringService(
                    model=None if manager is not None else model,
                    manager=manager,
                    config=entry.config,
                    model_id=entry.model_id,
                )
                try:
                    planes = self._planes(active, warm=service)
                except BaseException:
                    # a failed warm-up must not leave the flusher running
                    service.close()
                    if manager is not None:
                        manager.close()
                    raise
                nbytes = (
                    planes["device"]
                    if planes["placement"] == "device"
                    else planes["host"]
                )
        except Exception as exc:
            entry.last_load_error = repr(exc)
            degrade(
                "fleet_load_failed",
                f"fleet tenant {entry.model_id!r} lazy load",
                "typed 503 refusal (other tenants unaffected)",
                detail=(
                    f"loading {entry.model_dir} for tenant "
                    f"{entry.model_id!r} failed: {exc!r}; the registry "
                    "retries on the tenant's next request"
                ),
            )
            raise ModelLoadError(
                f"model {entry.model_id!r} failed to load ({exc!r}); "
                "retriable — the registry reloads on the next request"
            ) from exc
        entry.model = active
        entry.manager = manager
        entry.service = service
        entry.resident_bytes = nbytes
        entry.plane_bytes = planes
        entry.loads += 1
        entry.last_load_error = None
        with self._lock:
            self._resident_bytes += nbytes
            resident = sum(1 for e in self._entries.values() if e.resident)
            resident_bytes = self._resident_bytes
        _RESIDENT_MODELS.set(resident)
        _RESIDENT_BYTES.set(resident_bytes)
        _LOADS_TOTAL.inc(model_id=entry.model_id)
        _resources.account_resident_plane(
            entry.model_id,
            planes["host"],
            planes["device"],
            plane=planes["plane"],
        )
        record_event(
            "fleet.load",
            model_id=entry.model_id,
            bytes=nbytes,
            placement=planes["placement"],
            generation=entry.generation,
            load_seconds=round(time.perf_counter() - t0, 6),
            resident_models=resident,
            resident_bytes=resident_bytes,
        )
        logger.info(
            "fleet: loaded %s from %s (%d bytes resident, generation %s, "
            "%d resident / %d bytes total)",
            entry.model_id,
            entry.model_dir,
            nbytes,
            entry.generation,
            resident,
            resident_bytes,
        )

    @staticmethod
    def _planes(model, warm: Optional[ScoringService] = None) -> dict:
        """The tenant's plane bytes (``telemetry.resources.model_plane_bytes``
        form). On the CPU the JAX package's count; on the card the bytes it
        holds there (:func:`held_nbytes`), after ``warm``'s prewarm builds
        the tables of its batch bucket."""
        if not _counts_held_tables(model):
            return _resources.model_plane_bytes(model)
        if warm is not None:
            warm.prewarm()
        # the tables live on the card alone; a q16 tenant's are f32 there
        return {"host": 0, "device": held_nbytes(model),
                "plane": getattr(model, "scoring_representation", "f32"), "placement": "device"}

    def _recount(self, entry: ManagedEntry, service: ScoringService) -> None:
        """Re-read a card tenant's held bytes after a request (``auto`` may
        have built another strategy's tables, or a swap brought a new
        model) and enforce the budget when they grew."""
        model = service.model
        if not _counts_held_tables(model):
            return
        with entry._lock:
            if entry.service is not service:
                return  # evicted meanwhile
            planes = self._planes(model)
            delta = planes["device"] - entry.resident_bytes
            if delta == 0:
                return
            entry.resident_bytes = planes["device"]
            entry.plane_bytes = planes
            entry.model = model
            with self._lock:
                self._resident_bytes += delta
                resident_bytes = self._resident_bytes
        _RESIDENT_BYTES.set(resident_bytes)
        _resources.account_resident_plane(entry.model_id, planes["host"], planes["device"], plane=planes["plane"])
        if delta > 0:
            self._enforce_budget(exclude=entry.model_id)

    def _enforce_budget(self, exclude: Optional[str] = None) -> None:
        """Evict least-recently-used resident tenants until the fleet fits
        ``budget_bytes``. ``exclude`` protects the tenant whose load
        triggered enforcement (evicting the model a request is about to
        score would thrash). Pinned (mid-retrain) tenants are skipped; if
        nothing is evictable the fleet stays over budget with a warning —
        correctness over the budget, never a torn refit."""
        if self.budget_bytes is None:
            return
        while True:
            with self._lock:
                if self._resident_bytes <= self.budget_bytes:
                    return
                victims = sorted(
                    (
                        e
                        for e in self._entries.values()
                        if e.resident and e.model_id != exclude
                    ),
                    key=lambda e: e.last_used,
                )
            evicted = False
            for victim in victims:
                if self.evict(victim.model_id, cause=EVICT_BUDGET):
                    evicted = True
                    break
            if not evicted:
                with self._lock:
                    over = self._resident_bytes - self.budget_bytes
                logger.warning(
                    "fleet: %d bytes over the residency budget but no tenant "
                    "is evictable (pinned mid-retrain, or only the active "
                    "tenant remains); staying over budget",
                    max(over, 0),
                )
                return

    def evict(self, model_id: str, cause: str = EVICT_EXPLICIT) -> bool:
        """Evict one tenant's resident state: drain its coalescer (every
        in-flight flush completes on its point-in-time model reference,
        bitwise-exact), close its manager, release the packed planes. The
        sealed gen dirs stay authoritative — the next request re-loads,
        resuming the last swapped generation. Returns False (and refuses)
        when the tenant is not resident or is pinned mid-retrain."""
        entry = self.entry(model_id)
        with entry._lock:
            service = entry.service
            if service is None:
                return False
            manager = entry.manager
            if manager is not None and manager.retrain_in_progress:
                record_event(
                    "fleet.evict_refused",
                    model_id=entry.model_id,
                    cause=cause,
                    reason="retrain_in_progress",
                )
                logger.warning(
                    "fleet: refusing to evict %s mid-retrain (pinned until "
                    "the swap or rollback completes)",
                    entry.model_id,
                )
                return False
            in_flight = service.coalescer.pending_rows
            if in_flight > 0:
                degrade(
                    "fleet_evict_under_load",
                    f"fleet tenant {entry.model_id!r} resident with "
                    f"{in_flight} in-flight row(s)",
                    "drain coalescer, then evict",
                    detail=(
                        f"eviction ({cause}) drained {in_flight} queued "
                        "row(s) first — in-flight flushes complete on their "
                        "point-in-time model reference, bitwise-exact"
                    ),
                )
            service.close()  # drain=True: no waiter is stranded
            if manager is not None:
                manager.close()
            freed = entry.resident_bytes
            entry.model = None
            entry.manager = None
            entry.service = None
            entry.resident_bytes = 0
            entry.plane_bytes = None
        with self._lock:
            self._resident_bytes -= freed
            resident = sum(1 for e in self._entries.values() if e.resident)
            resident_bytes = self._resident_bytes
        _RESIDENT_MODELS.set(resident)
        _RESIDENT_BYTES.set(resident_bytes)
        _EVICTIONS_TOTAL.inc(cause=cause)
        _resources.release_resident_plane(entry.model_id)
        record_event(
            "fleet.evict",
            model_id=entry.model_id,
            cause=cause,
            bytes=freed,
            resident_models=resident,
            resident_bytes=resident_bytes,
        )
        logger.info(
            "fleet: evicted %s (%s, %d bytes freed; %d resident / %d bytes "
            "total; gen dirs on disk stay authoritative)",
            entry.model_id,
            cause,
            freed,
            resident,
            resident_bytes,
        )
        return True

    # ------------------------------------------------------------------ #
    # scoring
    # ------------------------------------------------------------------ #

    def score(self, model_id: str, rows: np.ndarray) -> np.ndarray:
        """Score through the tenant's own coalescer (loading it first if
        cold). Raises the tenant's admission errors (429/503),
        :class:`UnknownModelError` or :class:`ModelLoadError` — all typed,
        all scoped to THIS tenant."""
        scores, _ = self.score_detail(model_id, rows)
        return scores

    def score_detail(
        self,
        model_id: str,
        rows: np.ndarray,
        idempotency_key: Optional[str] = None,
    ):
        """(scores, info) where info carries the flush accounting, the
        generation that scored the flush, the active model and its service
        (whose ``predict`` labels host scores).
        A request that races an eviction (service closed between lookup
        and submit) retries once against the re-loaded service.
        ``idempotency_key`` is the replicated tier's retry dedup: a key this tenant's service already answered
        replays fold-free (bitwise-same scores, drift counted once); a
        fresh key is recorded once the flush succeeds."""
        for attempt in (0, 1):
            entry = self.ensure_resident(model_id)
            service = entry.service  # point-in-time: eviction-safe
            if service is None:
                continue  # evicted between load and capture: reload
            # the autopilot's shed rung refuses this tenant before any
            # queue or replay work (typed 429 + Retry-After)
            service.check_admission()
            if idempotency_key is not None and service.idempotency_seen(
                idempotency_key
            ):
                scores, generation = service.score_replay(rows)
                info = {
                    "model": service.model,
                    "service": service,
                    "generation": generation,
                    "flush_rows": int(np.asarray(rows).shape[0]),
                    "flush_requests": 1,
                    "queue_wait_s": 0.0,
                    "flush_ctx": None,
                    "replayed": True,
                }
                return scores, info
            try:
                pending = service.coalescer.submit(rows)
            except CoalescerClosedError:
                if attempt:
                    raise
                continue  # raced an eviction: one reload retry
            if faults.evict_during_score():
                # the eviction-under-load drill: drain-then-evict while this
                # very request is in flight; its scores must still arrive,
                # bitwise-exact, from the drained flush
                self.evict(model_id, cause=EVICT_FAULT)
            scores = service.coalescer.result(
                pending, timeout_s=entry.config.request_timeout_s
            )
            service.record_idempotency(idempotency_key)
            self._recount(entry, service)
            info = {
                "model": service.model,
                "service": service,
                # the generation pinned with the model that scored the flush
                "generation": pending.generation,
                "flush_rows": pending.flush_rows,
                "flush_requests": pending.flush_requests,
                "queue_wait_s": pending.queue_wait_s,
                "flush_ctx": pending.flush_ctx,
            }
            degraded = service.quality
            if degraded is not None:
                info["degraded"] = degraded
            return scores, info
        raise ModelLoadError(
            f"model {model_id!r} was evicted twice while the request was "
            "being admitted; retry"
        )

    def refresh_from_current(self, model_id: str) -> dict:
        """The per-tenant leg of a rolling model push: re-read the tenant's ``CURRENT.json`` and
        adopt a newer generation in place. A non-resident tenant reloads
        nothing — its next lazy load resumes from ``CURRENT.json`` anyway,
        so the push reaches it by construction. Raises
        :class:`UnknownModelError` for unregistered ids."""
        entry = self.entry(model_id)
        with entry._lock:
            manager = entry.manager if entry.resident else None
        if manager is None:
            return {
                "model_id": entry.model_id,
                "resident": entry.resident,
                "lifecycle": entry.lifecycle,
                "reloaded": False,
                "generation": entry.generation,
            }
        changed = manager.refresh_from_current()
        return {
            "model_id": entry.model_id,
            "resident": True,
            "lifecycle": True,
            "reloaded": bool(changed),
            "generation": manager.generation,
        }

    # ------------------------------------------------------------------ #
    # teardown
    # ------------------------------------------------------------------ #

    def close(self) -> None:
        """Tear the whole fleet down: wait out in-flight retrains (a
        shutdown never tears a refit), drain every coalescer, release
        everything. Idempotent."""
        with self._lock:
            if self.closed:
                return
            self.closed = True
            entries = list(self._entries.values())
        for entry in entries:
            manager = entry.manager
            if manager is not None:
                manager.wait_retrain()  # un-pins: shutdown is orderly
            self.evict(entry.model_id, cause=EVICT_CLOSE)
