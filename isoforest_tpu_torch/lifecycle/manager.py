"""ModelManager: from drift detection to a validated swap
(``isoforest_tpu/lifecycle/manager.py``).

The manager owns the active model, its
:class:`~isoforest_tpu_torch.telemetry.monitor.ScoreMonitor` and a
recent-data reservoir, and runs the JAX package's state machine::

    SERVING --sustained drift (debounced)--> RETRAINING
    RETRAINING --checkpointed refit (killed? resumes)--> VALIDATING
    VALIDATING --gates pass--> SWAPPING --atomic flip--> SERVING (gen+1)
    VALIDATING --gates fail--> SERVING (incumbent untouched, rollback event)
    SWAPPING   --fault------>  SERVING (incumbent untouched, rollback event)

* **Debounce.** Each scored batch past the monitor's ``min_rows`` is one
  drift evaluation; ``drift_debounce`` over-threshold evaluations in a row
  (score PSI or any feature PSI) trigger a refit.
* **Refit.** The candidate grows through the port's checkpointed fit on the
  incumbent's device (``fit(..., checkpoint_dir=, block_callback=)``) under
  :func:`~..resilience.retry.retry_call`: a killed attempt resumes from its
  sealed blocks, and the candidate equals an uninterrupted refit of the same
  window bit for bit. Every kernel it runs (the threshold pass, the baseline
  capture, the validation scores) is the card's; a failure ends in
  ``retrain.rollback`` with the error, never on another device.
* **Validation.** :func:`~.validation.validate_candidate` holds the
  candidate to the incumbent on a stride sample of the window.
* **Swap.** The candidate is saved atomically (a sealed ``gen-<N>``
  directory), the work it queued on the retrain thread's stream is waited
  for, and the model reference flips under the swap lock: a scorer in
  flight finishes on the reference it took, so no call sees a torn mix of
  two forests. The monitor object survives the swap
  (:meth:`ScoreMonitor.rebind`). ``CURRENT.json`` then names the live
  generation, and a restarted manager resumes it.
* **Sliding refresh.** ``mode="sliding"`` retires the oldest
  ``round(T * sliding_fraction)`` trees and grows replacements on the
  window with the port's draws (the JAX package's threefry streams).

Each transition records an event (``retrain.start``, ``retrain.block``,
``retrain.validate``, ``retrain.swap``, ``retrain.rollback``,
``lifecycle.resume``, ``lifecycle.refresh``) and sets the JAX package's
gauges and counter. The work directory is the JAX package's layout: each
package's manager resumes the other's.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
import weakref
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..resilience import faults
from ..resilience.retry import RetryError, RetryPolicy, retry_call
from ..telemetry.events import record_event
from ..telemetry.metrics import counter as _counter, gauge as _gauge
from ..telemetry.spans import span as _span
from ..utils.logging import logger
from .validation import ValidationGates, ValidationResult, validate_candidate
from .window import DataReservoir, DecayReservoir

CURRENT_NAME = "CURRENT.json"

_GENERATION = _gauge(
    "isoforest_model_generation",
    "Active model generation under the lifecycle manager "
    "(1 = the incumbent the manager started with)",
)
_RETRAIN_IN_PROGRESS = _gauge(
    "isoforest_retrain_in_progress",
    "1 while a drift-triggered refit is running, else 0",
)
_RETRAIN_TOTAL = _counter(
    "isoforest_retrain_total",
    "Drift-triggered retrain attempts, by terminal outcome "
    "(swapped | validation_failed | swap_failed | error)",
    labelnames=("outcome",),
)
# the per-tenant twin of isoforest_model_generation (managers built with model_id=)
_FLEET_GENERATION = _gauge(
    "isoforest_fleet_generation",
    "Per-tenant active model generation under the fleet registry's "
    "lifecycle managers (docs/fleet.md)",
    labelnames=("model_id",),
)

# terminal retrain outcomes (the {outcome=} label values)
OUTCOME_SWAPPED = "swapped"
OUTCOME_VALIDATION_FAILED = "validation_failed"
OUTCOME_SWAP_FAILED = "swap_failed"
OUTCOME_ERROR = "error"


def retrain_seed(base_seed: int, generation: int) -> int:
    """The refit seed of a generation: reproducible, and a stream apart from
    the incumbent's, so a refit is a fresh ensemble."""
    return int((int(base_seed) + 7919 * int(generation)) & 0x7FFFFFFF)


# the most recently constructed manager not yet closed; the telemetry HTTP
# daemon shows its state() on /healthz and /snapshot
_ACTIVE_REF: Optional["weakref.ref[ModelManager]"] = None


def state_snapshot() -> Optional[dict]:
    """The live manager's :meth:`ModelManager.state`, or None when no
    manager is live in this process (read by ``telemetry/http.py``)."""
    manager = _ACTIVE_REF() if _ACTIVE_REF is not None else None
    if manager is None or manager.closed:
        return None
    return manager.state()


def _settle(device: torch.device) -> None:
    """Wait for the work this thread queued on the card (its current stream,
    which every copy stream it used was joined into) before another thread
    may read what it produced."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


class ModelManager:
    """Serve, watch, retrain, validate and swap one model lineage.

    ``model`` must carry a drift baseline (a fit with capture on, or a
    directory with ``_BASELINE.json``). ``work_dir`` holds the swapped
    generations (``gen-<N>``, each a sealed model directory), ``CURRENT.json``
    and the refits' checkpoints (``retrain/r<seq>``).

    The knobs are the JAX package's: ``monitor_threshold``/``monitor_kwargs``
    configure the monitor; ``drift_debounce`` the over-threshold evaluations
    in a row that trigger; ``window_rows`` the reservoir's size and
    ``min_window_rows`` the least window a refit runs on; ``reservoir``
    ``"fifo"`` or ``"decay"`` (``reservoir_half_life_s``,
    ``reservoir_seed``, default the model's seed); ``mode`` ``"full"`` or
    ``"sliding"`` (``sliding_fraction`` of the oldest trees retired a swap);
    ``checkpoint_every`` the refit's block size; ``gates`` the validation
    bounds; ``auto_retrain=False`` leaves refits to :meth:`retrain`;
    ``background=False`` refits inside the triggering ``score`` call;
    ``retry_policy``, ``clock`` and ``sleep`` drive the retry (tests pass a
    :class:`~..resilience.faults.FakeClock`); ``hooks["mid_swap"]`` runs
    after the candidate's durable save and before the flip; ``resume=True``
    serves the generation ``work_dir/CURRENT.json`` names, when it is a
    sealed directory with a baseline, loaded onto the given model's device;
    ``model_id`` names a fleet tenant in events, the monitor and the state.
    """

    def __init__(
        self,
        model,
        work_dir: str,
        *,
        monitor_threshold: Optional[float] = None,
        drift_debounce: int = 3,
        window_rows: int = 65536,
        min_window_rows: int = 1024,
        mode: str = "full",
        sliding_fraction: float = 0.5,
        reservoir: str = "fifo",
        reservoir_half_life_s: float = 3600.0,
        reservoir_seed: Optional[int] = None,
        checkpoint_every: Optional[int] = None,
        gates: Optional[ValidationGates] = None,
        auto_retrain: bool = True,
        background: bool = True,
        retry_policy: Optional[RetryPolicy] = None,
        clock: Callable[[], float] = time.time,
        sleep: Callable[[float], None] = time.sleep,
        monitor_kwargs: Optional[dict] = None,
        hooks: Optional[Dict[str, Callable[[], None]]] = None,
        resume: bool = True,
        model_id: Optional[str] = None,
    ) -> None:
        if model.baseline is None:
            raise ValueError(
                "lifecycle management requires a drift baseline: fit with "
                "baseline capture enabled, or load a model dir carrying the "
                "_BASELINE.json sidecar"
            )
        if mode not in ("full", "sliding"):
            raise ValueError(f"mode must be 'full' or 'sliding', got {mode!r}")
        if drift_debounce < 1:
            raise ValueError(f"drift_debounce must be >= 1, got {drift_debounce}")
        if not 0.0 < sliding_fraction <= 1.0:
            raise ValueError(f"sliding_fraction must be in (0, 1], got {sliding_fraction}")
        if reservoir not in ("fifo", "decay"):
            raise ValueError(f"reservoir must be 'fifo' or 'decay', got {reservoir!r}")
        self.model_id = None if model_id is None else str(model_id)
        self.work_dir = str(work_dir)
        os.makedirs(self.work_dir, exist_ok=True)
        self.mode = mode
        self.sliding_fraction = float(sliding_fraction)
        self.drift_debounce = int(drift_debounce)
        self.min_window_rows = int(min_window_rows)
        self.checkpoint_every = checkpoint_every
        self.gates = gates or ValidationGates()
        self.auto_retrain = bool(auto_retrain)
        self.background = bool(background)
        self.retry_policy = retry_policy or RetryPolicy(max_attempts=3, base_delay_s=0.5, max_delay_s=10.0)
        self.reservoir_mode = reservoir
        if reservoir == "decay":
            seed = int(model.params.random_seed) if reservoir_seed is None else int(reservoir_seed)
            self.reservoir = DecayReservoir(window_rows, half_life_s=reservoir_half_life_s, seed=seed, clock=clock)
        else:
            self.reservoir = DataReservoir(window_rows)
        self.generation = 1
        self.model_path: Optional[str] = None
        self.last_swap_unix_s: Optional[float] = None
        self.last_retrain: Optional[dict] = None
        self.last_validation: Optional[ValidationResult] = None
        self.last_error: Optional[BaseException] = None
        # seconds the last swap held the swap lock (the flip alone)
        self.last_swap_lock_hold_s: Optional[float] = None
        self.closed = False
        self._clock = clock
        self._sleep = sleep
        self._hooks = dict(hooks or {})
        self._lock = threading.Lock()
        self._model = model
        self._consecutive = 0
        self._retrain_seq = 0
        self._retraining = False
        self._retrain_thread: Optional[threading.Thread] = None
        self._outcomes: Dict[str, int] = {}
        if resume:
            self._resume_from_current()
        kwargs = dict(monitor_kwargs or {})
        if monitor_threshold is not None:
            kwargs["threshold"] = monitor_threshold
        if self.model_id is not None:
            kwargs.setdefault("model_id", self.model_id)
        self._monitor = self._model.enable_monitoring(**kwargs)
        _GENERATION.set(self.generation)
        if self.model_id is not None:
            _FLEET_GENERATION.set(self.generation, model_id=self.model_id)
        _RETRAIN_IN_PROGRESS.set(0)
        global _ACTIVE_REF
        _ACTIVE_REF = weakref.ref(self)

    def _read_current(self) -> dict:
        with open(os.path.join(self.work_dir, CURRENT_NAME)) as fh:
            return json.load(fh)

    def _load_generation(self, path: str):
        """A sealed generation directory, loaded onto the active model's
        device (never the default one: a CPU manager stays on the CPU, and a
        card process holds one device)."""
        from ..io.persistence import load_model

        return load_model(path, device=self._model.device)

    def _resume_from_current(self) -> bool:
        """Serve the generation ``work_dir/CURRENT.json`` names. Any failure
        (a missing or torn pointer, an unsealed or corrupt directory, no
        baseline) logs a warning and keeps the given model at generation 1."""
        current = os.path.join(self.work_dir, CURRENT_NAME)
        if not os.path.exists(current):
            return False
        try:
            doc = self._read_current()
            generation = int(doc["generation"])
            path = doc["path"]
            model = self._load_generation(path)
        except Exception as exc:
            logger.warning("lifecycle: could not resume from %s (%s); starting from the provided model at "
                           "generation 1", current, exc)
            return False
        if model.baseline is None:
            logger.warning("lifecycle: %s carries no _BASELINE.json sidecar; cannot resume monitoring from it — "
                           "starting from the provided model at generation 1", path)
            return False
        self._model = model
        self.generation = generation
        self.model_path = path
        swapped = doc.get("swapped_unix_s")
        self.last_swap_unix_s = float(swapped) if swapped is not None else None
        record_event("lifecycle.resume", generation=generation, path=path, swapped_unix_s=self.last_swap_unix_s,
                     **self._tenant_fields())
        logger.info("lifecycle: resumed generation %d from %s (CURRENT.json)", generation, path)
        return True

    def _tenant_fields(self) -> Dict[str, str]:
        """``model_id=`` of a fleet tenant's events; nothing otherwise."""
        return {} if self.model_id is None else {"model_id": self.model_id}

    # ------------------------------------------------------------------ #
    # serving path
    # ------------------------------------------------------------------ #

    @property
    def model(self):
        """The active model: a point-in-time reference that stays whole if
        a swap lands while it scores."""
        with self._lock:
            return self._model

    @property
    def monitor(self):
        return self._monitor

    @property
    def retrain_in_progress(self) -> bool:
        """True while a refit is in flight."""
        with self._lock:
            return self._retraining

    def score(
        self,
        X,
        y: Optional[np.ndarray] = None,
        *,
        timeout_s: Optional[float] = None,
        strict: bool = False,
        chunk_size: Optional[int] = None,
        pipeline: Optional[bool] = None,
        return_generation: bool = False,
        fold: bool = True,
        fold_reservoir: bool = True,
    ):
        """Score a served batch on the active model (a float32 tensor on its
        device, as ``model.score`` gives; the monitor folds it), keep the
        rows (and labels, which arm the AUROC gate) in the reservoir, and
        run the debounced trigger. ``timeout_s``, ``strict``,
        ``chunk_size`` and ``pipeline`` go to ``model.score``.
        ``return_generation=True`` gives ``(scores, generation)``, the
        generation read in the same lock hold as the model that scored.
        ``fold=False`` feeds neither the monitor, the reservoir nor the
        trigger (a replayed request); ``fold_reservoir=False`` feeds the
        monitor but not the reservoir."""
        with self._lock:
            # one lock hold pins the model and its generation together
            model = self._model
            generation = self.generation
        with _span("lifecycle.score", rows=len(X), generation=generation, **self._tenant_fields()):
            scores = model.score(X, timeout_s=timeout_s, strict=strict, chunk_size=chunk_size, pipeline=pipeline,
                                 fold_monitor=fold)
        if fold:
            if fold_reservoir:
                self.reservoir.fold(X, y)
            self._maybe_trigger()
        if return_generation:
            return scores, generation
        return scores

    def _maybe_trigger(self) -> None:
        drift = self._monitor.drift()
        if "score" not in drift:
            return  # below min_rows: not an evaluation yet
        over = drift["score"]["psi"] > self._monitor.threshold
        if not over:
            features = drift.get("features") or {}
            over = any(v > self._monitor.feature_threshold for v in features.values())
        start = False
        with self._lock:
            self._consecutive = self._consecutive + 1 if over else 0
            if (
                self.auto_retrain
                and not self._retraining
                and self._consecutive >= self.drift_debounce
                and self.reservoir.rows >= self.min_window_rows
            ):
                self._consecutive = 0
                start = True
        if start:
            self._start_retrain(reason="sustained_drift")

    # ------------------------------------------------------------------ #
    # retrain orchestration
    # ------------------------------------------------------------------ #

    def retrain(self, reason: str = "manual", wait: bool = True) -> Optional[str]:
        """Retrain now, drift or not. Returns the terminal outcome when
        ``wait`` (or the manager is synchronous), ``"started"`` for a
        background refit not waited for, and None when nothing started (one
        in flight, an empty reservoir, or closed)."""
        if not self._start_retrain(reason=reason):
            return None
        if not wait:
            return "started"
        self.wait_retrain()
        return self.last_retrain.get("outcome") if self.last_retrain else None

    def wait_retrain(self, timeout_s: Optional[float] = None) -> bool:
        """Join a background refit in flight; True once idle."""
        with self._lock:
            thread = self._retrain_thread
        if thread is not None and thread.is_alive():
            thread.join(timeout_s)
        with self._lock:
            return not self._retraining

    def _start_retrain(self, reason: str) -> bool:
        with self._lock:
            if self._retraining or self.closed:
                return False
            window_X, window_y = self.reservoir.snapshot()
            if window_X.shape[0] < 1:
                logger.warning("lifecycle: retrain requested (%s) but the reservoir is empty; serve traffic "
                               "through manager.score first", reason)
                return False
            self._retraining = True
            self._retrain_seq += 1
            seq = self._retrain_seq
            incumbent = self._model
        _RETRAIN_IN_PROGRESS.set(1)
        target = self.generation + 1
        seed = retrain_seed(incumbent.params.random_seed, target)
        self.last_retrain = {"seq": seq, "generation": target, "reason": reason, "mode": self.mode,
                             "rows": int(window_X.shape[0]), "seed": seed, "window": window_X, "outcome": None}
        record_event("retrain.start", seq=seq, generation=target, reason=reason, mode=self.mode,
                     rows=int(window_X.shape[0]), seed=seed, **self._tenant_fields())
        if self.background:
            thread = threading.Thread(target=self._retrain_body,
                                      args=(incumbent, window_X, window_y, seq, target, seed),
                                      daemon=True, name=f"isoforest-retrain[r{seq}]")
            with self._lock:
                self._retrain_thread = thread
            thread.start()
        else:
            self._retrain_body(incumbent, window_X, window_y, seq, target, seed)
        return True

    def _finish(self, outcome: str) -> None:
        with self._lock:
            self._retraining = False
            self._outcomes[outcome] = self._outcomes.get(outcome, 0) + 1
            if self.last_retrain is not None:
                self.last_retrain["outcome"] = outcome
        _RETRAIN_IN_PROGRESS.set(0)
        _RETRAIN_TOTAL.inc(outcome=outcome)

    def _rollback(self, seq: int, target: int, outcome: str, reason: str, exc: Optional[BaseException] = None,
                  **fields) -> None:
        if exc is not None:
            self.last_error = exc
            fields["error"] = repr(exc)
        record_event("retrain.rollback", seq=seq, generation=target, reason=reason, **fields,
                     **self._tenant_fields())
        self._finish(outcome)

    def _checkpoint_dir(self, seq: int) -> str:
        return os.path.join(self.work_dir, "retrain", f"r{seq:04d}")

    def _retrain_body(self, incumbent, window_X, window_y, seq: int, target: int, seed: int) -> None:
        ckpt_dir = self._checkpoint_dir(seq)
        try:
            try:
                candidate = retry_call(
                    lambda: self._fit_candidate(incumbent, window_X, seq, target, seed, ckpt_dir),
                    policy=self.retry_policy,
                    retry_on=(Exception,),
                    describe=f"lifecycle refit r{seq} (gen {target})",
                    clock=self._clock,
                    sleep=self._sleep,
                    seed=seed,
                )
            except RetryError as exc:
                self._rollback(seq, target, OUTCOME_ERROR, "retrain_error", exc)
                logger.error("lifecycle refit r%d failed every attempt: %s", seq, exc)
                return
            self._maybe_poison_candidate(candidate)
            try:
                result = validate_candidate(incumbent, candidate, window_X, window_y, gates=self.gates)
            except Exception as exc:
                # a kernel or CUDA failure while the gates score: the
                # incumbent keeps serving, and the refit ends here
                self._rollback(seq, target, OUTCOME_ERROR, "validation_error", exc)
                logger.error("lifecycle: validating candidate gen %d raised (%r); the incumbent keeps serving",
                             target, exc)
                return
            self.last_validation = result
            record_event("retrain.validate", seq=seq, generation=target, passed=result.passed,
                         reference_rows=result.reference_rows, gates=json.dumps(result.as_dict()["gates"]),
                         **self._tenant_fields())
            if not result.passed:
                self._rollback(seq, target, OUTCOME_VALIDATION_FAILED, "validation_failed",
                               failed_gates=",".join(result.failed_gates()))
                logger.warning("lifecycle: candidate gen %d failed validation (%s); the incumbent keeps serving "
                               "untouched", target, ", ".join(result.failed_gates()))
                return
            try:
                self._swap(candidate, seq, target)
            except Exception as exc:
                self._rollback(seq, target, OUTCOME_SWAP_FAILED, "swap_failed", exc)
                logger.error("lifecycle: swap to gen %d failed mid-flight (%s); the incumbent keeps serving "
                             "untouched", target, exc)
                return
            self._finish(OUTCOME_SWAPPED)
        finally:
            # terminal either way: this refit's checkpoints are spent
            shutil.rmtree(ckpt_dir, ignore_errors=True)

    # ------------------------------------------------------------------ #
    # candidate construction
    # ------------------------------------------------------------------ #

    def _fit_candidate(self, incumbent, window_X, seq: int, target: int, seed: int, ckpt_dir: str):
        sliding = self.mode == "sliding"
        if sliding and window_X.shape[0] < incumbent.num_samples and not incumbent.params.bootstrap:
            # a bag without replacement cannot draw num_samples rows from a
            # smaller window; a full refit resolves num_samples again
            logger.warning("lifecycle: window of %d rows is smaller than numSamples=%d; falling back from "
                           "sliding refresh to a full refit", window_X.shape[0], incumbent.num_samples)
            sliding = False
        if sliding:
            return self._sliding_candidate(incumbent, window_X, seq, target, seed)
        return self._full_candidate(incumbent, window_X, seq, target, seed, ckpt_dir)

    def _full_candidate(self, incumbent, window_X, seq: int, target: int, seed: int, ckpt_dir: str):
        from ..models.extended import ExtendedIsolationForest, ExtendedIsolationForestModel
        from ..models.isolation_forest import IsolationForest

        params = incumbent.params.replace(random_seed=seed)
        cls = ExtendedIsolationForest if isinstance(incumbent, ExtendedIsolationForestModel) else IsolationForest
        estimator = cls(params=params, device=incumbent.device)

        def on_block(index: int, start: int, stop: int, resumed: bool) -> None:
            record_event("retrain.block", seq=seq, generation=target, index=index, start=start, stop=stop,
                         resumed=bool(resumed))
            faults.take_retrain_kill(index)

        return estimator.fit(
            window_X,
            nonfinite="allow",  # the serving path already applied the policy
            checkpoint_dir=ckpt_dir,
            checkpoint_every=self.checkpoint_every,
            resume=True,
            block_callback=on_block,
        )

    def _sliding_candidate(self, incumbent, window_X, seq: int, target: int, seed: int):
        """Retire the oldest trees and grow replacements on the window. Sound
        because the score is a mean over trees under one ``c(num_samples)``:
        trees of different vintages grown at the same ``num_samples`` (and
        height) make a valid forest."""
        from ..models.extended import ExtendedIsolationForestModel
        from ..models.isolation_forest import (
            _baseline_env_enabled,
            _capture_fit_baseline,
            _compute_and_set_threshold,
            _grow_block,
        )
        from ..ops import prng
        from ..ops.bagging import bagged_indices, feature_subsets, per_tree_keys
        from ..utils.math import height_limit

        forest = incumbent.forest
        dev = incumbent.device
        num_trees = forest.num_trees
        replace = min(num_trees, max(1, int(round(num_trees * self.sliding_fraction))))
        num_samples = incumbent.num_samples
        extended = isinstance(incumbent, ExtendedIsolationForestModel)

        k_bag, k_feat, k_grow = prng.split(prng.PRNGKey(seed & 0xFFFFFFFF, device=dev), 3)
        Xd = torch.from_numpy(np.ascontiguousarray(window_X, np.float32)).to(dev)
        bag = bagged_indices(k_bag, int(window_X.shape[0]), num_samples, replace, incumbent.params.bootstrap)
        fidx = feature_subsets(k_feat, int(window_X.shape[1]), incumbent.num_features, replace)
        tree_keys = per_tree_keys(k_grow, replace)
        block = _grow_block(tree_keys, Xd, bag, fidx, height_limit(num_samples),
                            incumbent.extension_level if extended else None)

        merged = {}
        for field in forest._fields:
            old, new = getattr(forest, field), getattr(block, field)
            if old.shape[1:] != new.shape[1:]:
                raise ValueError(
                    f"sliding refresh produced a mismatched {field!r} plane ({tuple(new.shape[1:])} vs incumbent "
                    f"{tuple(old.shape[1:])}); the window cannot be grown at the incumbent's geometry"
                )
            merged[field] = torch.cat([old[replace:], new])
        record_event("retrain.block", seq=seq, generation=target, index=0, start=0, stop=replace, resumed=False,
                     sliding=True, retired_trees=replace)

        common = dict(forest=type(forest)(**merged), params=incumbent.params, num_samples=num_samples,
                      num_features=incumbent.num_features, total_num_features=incumbent.total_num_features)
        if extended:
            candidate = type(incumbent)(extension_level=incumbent.extension_level, **common)
        else:
            candidate = type(incumbent)(**common)
        candidate.finalize_scoring()
        _compute_and_set_threshold(candidate, Xd)
        if _baseline_env_enabled():
            _capture_fit_baseline(candidate, Xd)
        return candidate

    def _maybe_poison_candidate(self, candidate) -> None:
        """``corrupt_candidate`` fault seam: NaN into the candidate's first
        float plane before validation. The model's table cache is emptied
        first, so the poisoned forest is what the gates score, not the
        tables its clean forest built."""
        if not faults.candidate_corrupted():
            return
        forest = candidate.forest
        for field in forest._fields:
            plane = getattr(forest, field)
            if plane.is_floating_point():
                candidate.forest = forest._replace(**{field: torch.full_like(plane, float("nan"))})
                candidate._cache.clear()
                candidate.finalize_scoring()
                logger.warning("lifecycle: injected corrupt_candidate fault poisoned the candidate's %r plane "
                               "before validation", field)
                return

    # ------------------------------------------------------------------ #
    # swap
    # ------------------------------------------------------------------ #

    def _generation_dir(self, generation: int) -> str:
        return os.path.join(self.work_dir, f"gen-{generation:05d}")

    def _swap(self, candidate, seq: int, target: int) -> None:
        gen_dir = self._generation_dir(target)
        try:
            # durable first: the atomic, manifest-sealed save is the swap's
            # primitive, and a crash after it loses nothing
            candidate.save(gen_dir, overwrite=True)
            faults.check_swap()
            hook = self._hooks.get("mid_swap")
            if hook is not None:
                hook()
        except BaseException:
            shutil.rmtree(gen_dir, ignore_errors=True)
            raise
        # the candidate's tables and baseline were built on this thread's
        # stream: a scorer on another thread reads them after the flip
        _settle(candidate.device)
        with self._lock:
            t0 = time.perf_counter()
            old = self._model
            # the monitor object survives: rebind re-targets it at the
            # candidate's baseline and re-arms its alerts
            self._monitor.rebind(candidate.baseline)
            candidate._monitor = self._monitor
            old._monitor = None
            self._model = candidate
            self.generation = target
            self.model_path = gen_dir
            self.last_swap_unix_s = float(self._clock())
            self._consecutive = 0
            self.last_swap_lock_hold_s = time.perf_counter() - t0
        _GENERATION.set(target)
        if self.model_id is not None:
            _FLEET_GENERATION.set(target, model_id=self.model_id)
        self._write_current(target, gen_dir)
        record_event("retrain.swap", seq=seq, generation=target, path=gen_dir, trees=candidate.forest.num_trees,
                     **self._tenant_fields())
        logger.info("lifecycle: generation %d swapped in from %s (monitor rebound, incumbent released)", target,
                    gen_dir)

    def _write_current(self, generation: int, path: str) -> None:
        """The atomic ``CURRENT.json`` pointer (a temporary file, then
        ``os.replace``): which sealed generation directory is live."""
        current = os.path.join(self.work_dir, CURRENT_NAME)
        tmp = f"{current}.tmp-{os.getpid()}"
        payload = {"generation": generation, "path": path, "swapped_unix_s": self.last_swap_unix_s}
        with open(tmp, "w") as fh:
            json.dump(payload, fh, indent=1, sort_keys=True)
            fh.write("\n")
        os.replace(tmp, current)

    def refresh_from_current(self) -> bool:
        """Adopt a newer generation another process swapped into
        ``work_dir`` (``POST /reload``): when ``CURRENT.json`` names a
        generation ahead of the active one, load it onto the active model's
        device and flip under the swap lock, as :meth:`_swap` does. True
        when the active model changed; any failure logs a warning and keeps
        the incumbent."""
        current = os.path.join(self.work_dir, CURRENT_NAME)
        try:
            doc = self._read_current()
            target = int(doc["generation"])
            path = doc["path"]
        except OSError:
            return False  # no pointer yet: nothing pushed
        except (ValueError, KeyError, TypeError) as exc:
            logger.warning("lifecycle: unreadable %s (%s); keeping generation %d", current, exc, self.generation)
            return False
        with self._lock:
            if target <= self.generation:
                return False  # our own swap, or an older push
        try:
            candidate = self._load_generation(path)
        except Exception as exc:
            logger.warning("lifecycle: could not load pushed generation %d from %s (%s); keeping generation %d",
                           target, path, exc, self.generation)
            return False
        if candidate.baseline is None:
            logger.warning("lifecycle: pushed generation %d at %s carries no _BASELINE.json sidecar; keeping "
                           "generation %d", target, path, self.generation)
            return False
        with self._lock:
            if target <= self.generation:
                return False  # a concurrent swap or refresh got there first
            old = self._model
            self._monitor.rebind(candidate.baseline)
            candidate._monitor = self._monitor
            old._monitor = None
            self._model = candidate
            self.generation = target
            self.model_path = path
            swapped = doc.get("swapped_unix_s")
            self.last_swap_unix_s = float(swapped) if swapped is not None else float(self._clock())
            self._consecutive = 0
        _GENERATION.set(target)
        if self.model_id is not None:
            _FLEET_GENERATION.set(target, model_id=self.model_id)
        record_event("lifecycle.refresh", generation=target, path=path, swapped_unix_s=self.last_swap_unix_s,
                     **self._tenant_fields())
        logger.info("lifecycle: adopted pushed generation %d from %s (CURRENT.json)", target, path)
        return True

    # ------------------------------------------------------------------ #
    # observability and teardown
    # ------------------------------------------------------------------ #

    def state(self) -> dict:
        """The lifecycle's state in plain JSON types (``/healthz`` and
        ``/snapshot``), key for key the JAX package's."""
        with self._lock:
            retraining = self._retraining
            consecutive = self._consecutive
            outcomes = dict(self._outcomes)
            uid = self._model.uid
        last = self.last_retrain
        return {
            "model_id": self.model_id,
            "generation": self.generation,
            "mode": self.mode,
            "model_uid": uid,
            "model_path": self.model_path,
            "last_swap_unix_s": self.last_swap_unix_s,
            "retrain_in_progress": retraining,
            "drift_debounce": self.drift_debounce,
            "consecutive_over_threshold": consecutive,
            "window_rows": self.reservoir.rows,
            "window_capacity": self.reservoir.capacity,
            "reservoir": self.reservoir_mode,
            "retrains": outcomes,
            "last_outcome": None if last is None else last.get("outcome"),
            "last_error": None if self.last_error is None else repr(self.last_error),
        }

    def close(self) -> None:
        """Stop auto-retraining, wait out a refit in flight, detach the
        monitor and leave the HTTP state. Idempotent."""
        if self.closed:
            return
        self.auto_retrain = False
        self.wait_retrain()
        self.closed = True
        self.model.disable_monitoring()
        global _ACTIVE_REF
        if _ACTIVE_REF is not None and _ACTIVE_REF() is self:
            _ACTIVE_REF = None
