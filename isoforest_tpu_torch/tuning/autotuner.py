"""Measured strategy autotuner behind ``strategy="auto"``
(``isoforest_tpu/tuning/autotuner.py``).

On the first encounter of a decision key, ``(platform, model-shape bucket,
batch bucket, extended?)``, :func:`resolve_decision` runs a short warmed
best-of-k timed probe of every eligible strategy and persists the winner
(:mod:`.cost_model`), so every later resolution in the fleet is a dict hit.

* **The pool.** ``walk`` and ``dense``, in that order, so ties go to the
  walk; ``dense`` only for trees within ``dense.DENSE_MAX_HEIGHT``, the
  height fence of the dense kernels of both forest types; on the CPU also
  ``q16``, last, for forests inside the quantized plane's fences
  (:func:`eligible_strategies`). On the card ``q16`` is torch ops, 10-560x
  slower than the walk and dense kernels (PERF.md), so probing it would
  only add its time to a cold key's first call: the JAX package likewise
  pools only strategies that can serve on the platform. Forests inside the
  fences key with the JAX package's ``|q16`` facet on every platform, so
  the keys equal its keys. The platform is the device type, ``cuda`` or
  ``cpu``. The ``|jittable`` pool waits for the sharded paths.
* **The probe.** The leading rows of the batch, tiled up to
  ``min(batch bucket, chunk rows, cap)`` rows and put on the device, so the
  probe times what one chunk of the call will run and not the copy of X.
  The cap is ``ISOFOREST_TPU_AUTOTUNE_PROBE_ROWS``, by default 2^20 on the
  card: the JAX package's 65,536 lies below the walk kernel's bulk launch
  (``ext_path.TREE_PARALLEL_MAX_ROWS``), so a 1M-row key would rank the
  small-batch walk against ``dense`` and serve the bulk walk; on the card the
  chunk rows bound the probe instead. Each strategy runs once to warm up
  (building its tables and its kernel), then up to ``reps`` times, each
  timed on the host clock between ``torch.cuda.synchronize()`` calls, until
  the soft budget is spent; the best time counts.
* **No fallback.** A probe that raises propagates: the JAX package's
  ``autotune_probe_failed`` rung would fall back to another kernel.

Every ``auto`` resolution emits exactly one ``autotune.decision`` event and
one ``isoforest_autotune_decisions_total{source=}`` tick, with ``source`` in
``table``, ``probe``, ``pin``, ``fallback``. Probes run with the scoring
series suppressed (:func:`~..ops.traversal.suppress_scoring_metrics`).

The environment variables are the JAX package's: ``ISOFOREST_TPU_STRATEGY``
pins a strategy (source ``pin``, beats the table; one the port does not know
takes the ``env_strategy_unknown`` rung and resolution goes on),
``ISOFOREST_TPU_AUTOTUNE=0`` bypasses the tuner (the static default, the
walk, source ``fallback``), ``ISOFOREST_TPU_AUTOTUNE_PROBE_ROWS`` /
``_REPS`` / ``_BUDGET_S`` bound a probe, ``_TTL_S`` / ``_PATH`` the table.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..telemetry import resources as _resources
from ..telemetry.events import record_event
from ..telemetry.metrics import counter as _telemetry_counter
from .cost_model import cost_model

DECISION_SOURCES = ("table", "probe", "pin", "fallback")

STATIC_DEFAULT = "walk"

# probe-row caps by platform (module docstring)
DEFAULT_PROBE_ROWS = {"cuda": 1 << 20, "cpu": 65_536}
DEFAULT_PROBE_REPS = 2
DEFAULT_PROBE_BUDGET_S = 2.0

# the packed layout's feature-id narrowing classes (the JAX package's
# scoring_layout boundaries): keys split at these widths, as there
_I8_MAX_FEATURES = 128
_I16_MAX_FEATURES = 32768

_DECISIONS_TOTAL = _telemetry_counter(
    "isoforest_autotune_decisions_total",
    "strategy='auto' resolutions by decision source",
    labelnames=("source",),
)

# cold probes are serialised: threads hitting one cold key pay it once
_PROBE_LOCK = threading.Lock()


class Decision(NamedTuple):
    """One resolved ``auto`` decision (already emitted to telemetry)."""

    strategy: str
    source: str  # one of DECISION_SOURCES
    key: str
    timings_s: Optional[Dict[str, Optional[float]]] = None
    refresh: bool = False


def autotune_enabled() -> bool:
    """``ISOFOREST_TPU_AUTOTUNE`` gate, default on (0/false/off/no bypass)."""
    return os.environ.get("ISOFOREST_TPU_AUTOTUNE", "1").strip().lower() not in ("0", "false", "off", "no")


def _env_number(name: str, default, cast):
    try:
        return cast(os.environ.get(name, default))
    except ValueError:
        return default


def _probe_rows_cap(platform: str) -> int:
    default = DEFAULT_PROBE_ROWS.get(platform, DEFAULT_PROBE_ROWS["cpu"])
    return max(1, _env_number("ISOFOREST_TPU_AUTOTUNE_PROBE_ROWS", default, int))


def _probe_reps() -> int:
    return max(1, _env_number("ISOFOREST_TPU_AUTOTUNE_REPS", DEFAULT_PROBE_REPS, int))


def _probe_budget_s() -> float:
    return _env_number("ISOFOREST_TPU_AUTOTUNE_BUDGET_S", DEFAULT_PROBE_BUDGET_S, float)


# -- decision keys --------------------------------------------------------


def _pow2_ceil(n: int) -> int:
    return 1 << (max(int(n), 1) - 1).bit_length()


def _feature_class(num_features: int) -> str:
    if num_features <= _I8_MAX_FEATURES:
        return "i8"
    if num_features <= _I16_MAX_FEATURES:
        return "i16"
    return "i32"


def _extended(forest) -> bool:
    from ..ops.ext_growth import ExtendedForest

    return isinstance(forest, ExtendedForest)


def model_bucket(forest, num_features: int) -> str:
    """Shape bucket of a forest: tree count (pow2), heap height, feature-id
    class, and the hyperplane arity of an extended forest."""
    base = f"t{_pow2_ceil(forest.num_trees)}h{forest.height}{_feature_class(int(num_features))}"
    return base + (f"k{forest.k}" if _extended(forest) else "")


def decision_key(platform: str, forest, num_rows: int, num_features: int,
                 cache: Optional[dict] = None) -> str:
    """The persisted table's key: the JAX package's for the same forest and
    batch, but for the platform string, the ``|q16`` facet of a forest the
    q16 plane covers included. ``cache``, the caller's per-forest dict,
    keeps the fence's verdict
    (:func:`~..ops.scoring_layout.quantized_unsupported_reason`)."""
    from ..ops.scoring_layout import quantized_eligible
    from ..ops.traversal import batch_bucket

    ext = "ext" if _extended(forest) else "std"
    key = f"v1|{platform}|{model_bucket(forest, num_features)}|b{batch_bucket(num_rows)}|{ext}"
    return key + "|q16" if quantized_eligible(forest, cache) else key


# -- eligibility ----------------------------------------------------------


def eligible_strategies(forest, platform: str = "cuda", cache: Optional[dict] = None) -> Tuple[str, ...]:
    """Strategies worth probing for this forest on ``platform``, in
    preference order (ties in the timed ranking go to the front): the walk,
    then ``dense`` for trees within the dense kernels' height fence, then,
    off the card, ``q16`` for forests inside the quantized plane's fences
    (the module docstring says why the card leaves it out). ``cache`` as
    for :func:`decision_key`."""
    from ..ops.dense import DENSE_MAX_HEIGHT
    from ..ops.scoring_layout import quantized_eligible

    pool = ["walk"]
    if forest.height <= DENSE_MAX_HEIGHT:
        pool.append("dense")
    if platform != "cuda" and quantized_eligible(forest, cache):
        pool.append("q16")
    return tuple(pool)


# -- probing --------------------------------------------------------------


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _probe(forest, Xp: torch.Tensor, num_samples: int, eligible, cache: Optional[dict] = None
           ) -> Dict[str, float]:
    """Warmed best-of-k host-clock seconds per eligible strategy over the
    probe rows, each run between synchronisations. The warm-up builds the
    strategy's tables (into ``cache``) and kernel; one slower than the
    budget stands as that strategy's time. A strategy that raises
    propagates (no fallback)."""
    from ..ops import traversal

    reps, budget_s = _probe_reps(), _probe_budget_s()
    device = Xp.device
    timings: Dict[str, float] = {}

    def timed(strategy: str) -> float:
        _sync(device)
        t0 = time.perf_counter()
        traversal.score_matrix(forest, Xp, num_samples, strategy=strategy, device=device, cache=cache,
                               strict=True)
        _sync(device)
        return time.perf_counter() - t0

    with traversal.suppress_scoring_metrics():
        for strategy in eligible:
            warm = timed(strategy)
            if warm > budget_s:
                timings[strategy] = warm
                continue
            best, spent = None, 0.0
            for _ in range(reps):
                dt = timed(strategy)
                best = dt if best is None else min(best, dt)
                spent += dt
                if spent > budget_s:
                    break
            timings[strategy] = best
    return timings


def _probe_slice(X: torch.Tensor, rows: int, device: torch.device) -> torch.Tensor:
    """The leading ``rows`` rows of ``X`` on ``device``, tiled up when the
    batch is smaller (zeros for an empty one), so probes see real rows at
    the real width."""
    n = int(X.shape[0])
    if n == 0:
        return torch.zeros((rows, X.shape[1]), dtype=torch.float32, device=device)
    if n >= rows:
        return X[:rows].to(device).contiguous()
    return X.to(device)[torch.arange(rows, device=device) % n].contiguous()


# -- resolution -----------------------------------------------------------


def emit_decision(strategy: str, source: str, key: str, site: str, refresh: bool = False) -> None:
    """One counter tick + one timeline event per ``auto`` resolution."""
    _DECISIONS_TOTAL.inc(source=source)
    fields = {"source": source, "strategy": strategy, "key": key, "site": site}
    if refresh:
        fields["refresh"] = True
    record_event("autotune.decision", **fields)


def decision_counts() -> Dict[str, float]:
    """Current ``isoforest_autotune_decisions_total`` values by source."""
    return {s: _DECISIONS_TOTAL.value(source=s) for s in DECISION_SOURCES}


def resolve_decision(
    forest,
    X: torch.Tensor,
    num_samples: int,
    *,
    device=None,
    chunk_rows: Optional[int] = None,
    strict: bool = False,
    cache: Optional[dict] = None,
    refresh: bool = False,
    site: str = "score_matrix",
) -> Decision:
    """Resolve ``strategy="auto"`` for one scoring call of ``X`` (a tensor on
    the host or on ``device``, default the forest's, or an array); emits exactly one decision
    event and counter tick and returns the :class:`Decision`.

    Precedence: a valid ``ISOFOREST_TPU_STRATEGY`` pin (source ``pin``; an
    unknown one takes the ``env_strategy_unknown`` rung, which ``strict``
    turns into a raise, and resolution goes on); the tuner disabled (the
    static default, ``fallback``); the fresh persisted table (``table``);
    a cold or stale key's probe (``probe``). ``chunk_rows`` (default: the
    executor's) bounds the probe; ``cache`` is the model's table cache;
    ``refresh`` probes a fresh key again; ``site`` names the caller in the
    decision's event (``serving.prewarm`` for serving's warm-up)."""
    from ..ops import streaming, traversal
    from ..resilience.degradation import degrade

    from ..utils.validation import extract_features

    X, _ = extract_features(X, nonfinite="allow")
    device = torch.device(device) if device is not None else forest.device
    platform, static_default = device.type, STATIC_DEFAULT
    n = int(X.shape[0])
    key = decision_key(platform, forest, n, int(X.shape[1]), cache)

    pin = os.environ.get("ISOFOREST_TPU_STRATEGY") or None
    if pin is not None:
        if pin in traversal.STRATEGIES:
            emit_decision(pin, "pin", key, site)
            return Decision(pin, "pin", key)
        degrade("env_strategy_unknown", repr(pin), static_default, strict=strict,
                detail=f"ISOFOREST_TPU_STRATEGY={pin!r} is not one of {'/'.join(traversal.STRATEGIES)}; "
                       "resolving the measured/tuned default")

    if not autotune_enabled():
        emit_decision(static_default, "fallback", key, site)
        return Decision(static_default, "fallback", key)

    eligible = eligible_strategies(forest, platform, cache)
    entry, fresh = cost_model().lookup(key)
    if entry is not None and fresh and not refresh and entry["strategy"] in eligible:
        emit_decision(entry["strategy"], "table", key, site)
        return Decision(entry["strategy"], "table", key, entry.get("timings_s"))

    is_refresh = entry is not None
    with _PROBE_LOCK:
        # another thread may have probed this key while we waited
        entry2, fresh2 = cost_model().lookup(key)
        if entry2 is not None and fresh2 and not refresh and entry2["strategy"] in eligible:
            emit_decision(entry2["strategy"], "table", key, site)
            return Decision(entry2["strategy"], "table", key, entry2.get("timings_s"))
        chunk = streaming.resolve_chunk_rows(chunk_rows, platform)
        rows = max(1, min(traversal.batch_bucket(n), chunk, _probe_rows_cap(platform)))
        Xp = _probe_slice(X, rows, device)
        # a probe builds every eligible strategy's tables (and kernels) once:
        # an expected one-time cost even after serving marks steady
        with _resources.warmup_scope(), _resources.compile_scope("autotune.probe", key=key):
            timings = _probe(forest, Xp, num_samples, eligible, cache=cache)

    order = {s: i for i, s in enumerate(eligible)}
    winner = min(timings, key=lambda s: (timings[s], order[s]))
    new_entry = {
        "strategy": winner,
        "timings_s": {s: round(t, 6) for s, t in timings.items()},
        "probe_rows": int(Xp.shape[0]),
        "reps": _probe_reps(),
        "unix_s": time.time(),
    }
    cost_model().store(key, new_entry)
    record_event("autotune.probe", key=key, winner=winner, timings_s=new_entry["timings_s"],
                 probe_rows=new_entry["probe_rows"], refresh=is_refresh)
    emit_decision(winner, "probe", key, site, refresh=is_refresh)
    return Decision(winner, "probe", key, timings, refresh=is_refresh)


def table_snapshot() -> dict:
    """The persisted table document (:meth:`.cost_model.CostModel.snapshot`)."""
    return cost_model().snapshot()


def clear_table() -> bool:
    """Delete the persisted table; True if a file existed."""
    return cost_model().clear()


__all__ = [
    "DECISION_SOURCES",
    "Decision",
    "autotune_enabled",
    "clear_table",
    "cost_model",
    "decision_counts",
    "decision_key",
    "eligible_strategies",
    "emit_decision",
    "model_bucket",
    "resolve_decision",
    "table_snapshot",
]
