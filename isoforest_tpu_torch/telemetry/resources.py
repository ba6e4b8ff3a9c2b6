"""Resource accounting of the port: builds, memory and the flight recorder
(``isoforest_tpu/telemetry/resources.py``).

The public names, metric names, labels, help strings, :data:`BUNDLE_SCHEMA`
and :data:`BUNDLE_SECTIONS` are the JAX package's, so one dashboard reads
both packages. What differs is what feeds them on the card:

* **What counts as a compile.** The port compiles no XLA program. What a
  live request can pay for instead is a build: an ``nvcc`` build of a kernel
  source (``ops/_build.py``) or the first build of one strategy's kernel
  tables for a model (``ops/traversal.py::scoring_tables``: the path
  records, the dense and q16 planes). Both report through
  :mod:`..utils.monitoring`, and :func:`install_compile_listener` registers
  :func:`_on_event_duration` there, so each build ticks
  ``isoforest_compiles_total{site,phase}`` and ``isoforest_compile_seconds``
  and lands in the bounded compile log, attributed to the outermost open
  :func:`compile_scope` of the building thread (builds are synchronous in
  the thread that needs them). The process-wide phase starts at ``warmup``
  and flips to ``steady`` with :func:`mark_steady` (serving calls it after
  prewarm); a build after that, outside a :func:`warmup_scope`, records a
  ``compile.steady_recompile`` event: a live request paid for a build.
* **Memory.** The streaming executor notes the bytes of its two pinned host
  buffers (``isoforest_host_staging_bytes{site}`` and a peak per site); a
  resident model's plane bytes are :func:`model_plane_bytes`, the JAX
  package's layout bytes for the same model, placed on the ``device`` when
  the model's tensors are on the card.
* **Flight recorder.** :func:`build_bundle` assembles recent traces, the
  event tail, the metrics snapshot, the degradation ladder and the rungs
  taken, the autotune table, the compile log and roll-up, the memory
  watermarks and the config fingerprint, served at ``GET /debug/bundle``.

Everything is gated on the shared telemetry switch and
``ISOFOREST_TPU_RESOURCES`` (default on), as in the JAX package.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import sys
import threading
import time
from typing import Dict, List, Optional

from ..utils import monitoring
from . import _state
from .events import record_event
from .metrics import counter as _counter
from .metrics import gauge as _gauge
from .metrics import histogram as _histogram

# the build events that count as a compile (utils/monitoring.py)
_COMPILE_EVENTS = frozenset({monitoring.NVCC_BUILD_EVENT, monitoring.TABLE_BUILD_EVENT})

COMPILE_LOG_MAX = 256

PHASES = ("warmup", "steady")

PLACEMENTS = ("host", "device")

BUNDLE_SCHEMA = "isoforest-debug-bundle/1"

_COMPILE_SECONDS = _histogram(
    "isoforest_compile_seconds",
    "XLA backend-compile wall-clock seconds, by triggering program-build "
    "site (compile_scope attribution; 'unattributed' = no open scope)",
    labelnames=("site",),
)
_COMPILES_TOTAL = _counter(
    "isoforest_compiles_total",
    "XLA backend compiles by site and phase; phase='steady' after "
    "mark_steady() means a live request paid a compile (anomaly)",
    labelnames=("site", "phase"),
)
_HOST_STAGING = _gauge(
    "isoforest_host_staging_bytes",
    "Live bytes in the streaming executor's double host staging buffers, "
    "by call site (peak watermark in memory_watermarks())",
    labelnames=("site",),
)
_RESIDENT_PLANE = _gauge(
    "isoforest_resident_plane_bytes",
    "Resident packed scoring-plane bytes by placement: 'device' when "
    "committed puts target an accelerator, 'host' on the CPU fallback",
    labelnames=("placement",),
)

_OFF_VALUES = frozenset({"0", "false", "off", "no", "disabled"})

ENV_VAR = "ISOFOREST_TPU_RESOURCES"

_LOCAL = threading.local()
_LOCK = threading.Lock()
_COMPILE_LOG: collections.deque = collections.deque(maxlen=COMPILE_LOG_MAX)
_STAGING_PEAK: Dict[str, int] = {}
_PLANES: Dict[str, Dict[str, int]] = {}
_PHASE = "warmup"
_LISTENER_INSTALLED = False
_ENABLED = os.environ.get(ENV_VAR, "1").strip().lower() not in _OFF_VALUES


def resources_enabled() -> bool:
    """True when the resource plane records (both the shared telemetry
    switch and ``ISOFOREST_TPU_RESOURCES`` are on)."""
    return _ENABLED and _state.enabled()


def enable_resources() -> None:
    global _ENABLED
    _ENABLED = True


def disable_resources() -> None:
    """Stop recording; what was recorded stays readable."""
    global _ENABLED
    _ENABLED = False


# --------------------------------------------------------------------------- #
# build accounting
# --------------------------------------------------------------------------- #


def _frames() -> list:
    frames = getattr(_LOCAL, "frames", None)
    if frames is None:
        frames = _LOCAL.frames = []
    return frames


@contextlib.contextmanager
def compile_scope(site: str, key: Optional[str] = None):
    """Attribute any build inside the block to ``site``.

    Scopes nest; attribution goes to the outermost frame (the seam, such as
    ``serving.prewarm`` or ``autotune.probe``, rather than the executor
    under it), and every frame's ``key`` joins the compile log entry."""
    if not resources_enabled():
        yield
        return
    frames = _frames()
    frames.append((str(site), None if key is None else str(key)))
    try:
        yield
    finally:
        frames.pop()


def current_phase() -> str:
    """This thread's phase: a :func:`warmup_scope` override, else the
    process-wide phase."""
    override = getattr(_LOCAL, "phase", None)
    return override if override is not None else _PHASE


def mark_steady() -> None:
    """Flip the process-wide phase to ``steady``: every build after this
    point (outside a :func:`warmup_scope`) is an anomaly. Serving calls it
    once prewarm has built the kernels and tables of its buckets."""
    global _PHASE
    _PHASE = "steady"


def mark_warmup() -> None:
    """Reset the process-wide phase to ``warmup`` (tests, re-warming)."""
    global _PHASE
    _PHASE = "warmup"


@contextlib.contextmanager
def warmup_scope():
    """Count builds inside the block as ``warmup`` whatever the process
    phase: for expected one-time builds after steady state, such as the
    autotuner's probes."""
    prev = getattr(_LOCAL, "phase", None)
    _LOCAL.phase = "warmup"
    try:
        yield
    finally:
        _LOCAL.phase = prev


def _on_event_duration(event: str, duration: float, key: Optional[str] = None, **kw) -> None:
    """The registered build listener: one call per build, in the building
    thread. ``key`` names what was built (``nvcc:<source>``,
    ``tables:<strategy>``) and ends the compile log entry's key."""
    if event not in _COMPILE_EVENTS or not resources_enabled():
        return
    frames = getattr(_LOCAL, "frames", None) or ()
    site = frames[0][0] if frames else "unattributed"
    keys = [k for _s, k in frames if k] + ([str(key)] if key else [])
    phase = current_phase()
    seconds = float(duration)
    _COMPILE_SECONDS.observe(seconds, site=site)
    _COMPILES_TOTAL.inc(1, site=site, phase=phase)
    from .spans import current_context

    ctx = current_context()
    entry = {
        "site": site,
        "key": "/".join(keys) if keys else None,
        "phase": phase,
        "seconds": round(seconds, 6),
        "unix_s": round(time.time(), 3),
        "trace_id": ctx.trace_id if ctx is not None else None,
    }
    with _LOCK:
        _COMPILE_LOG.append(entry)
    if phase == "steady":
        # the anomaly this plane exists for: a live request paid for a build
        record_event("compile.steady_recompile", site=site, key=entry["key"] or "", seconds=entry["seconds"])


def install_compile_listener() -> bool:
    """Register the build listener with :mod:`..utils.monitoring`
    (idempotent; the listener gates on :func:`resources_enabled`). Returns
    True: the port's hook is always there."""
    global _LISTENER_INSTALLED
    with _LOCK:
        if not _LISTENER_INSTALLED:
            monitoring.register_event_duration_secs_listener(_on_event_duration)
            _LISTENER_INSTALLED = True
    return True


def compile_log() -> List[dict]:
    """The bounded compile log, oldest first."""
    with _LOCK:
        return [dict(e) for e in _COMPILE_LOG]


def compile_counts() -> dict:
    """Roll-up of ``isoforest_compiles_total``: total, by site, by phase."""
    snap = _COMPILES_TOTAL.snapshot()
    by_site: Dict[str, float] = {}
    by_phase: Dict[str, float] = {p: 0.0 for p in PHASES}
    total = 0.0
    for series in snap["series"]:
        value = float(series["value"])
        labels = series["labels"]
        total += value
        by_site[labels["site"]] = by_site.get(labels["site"], 0.0) + value
        by_phase[labels["phase"]] = by_phase.get(labels["phase"], 0.0) + value
    return {
        "total": int(total),
        "by_site": {s: int(v) for s, v in sorted(by_site.items())},
        "by_phase": {p: int(v) for p, v in sorted(by_phase.items())},
    }


def compile_seconds_total() -> float:
    """Cumulative build wall-clock across every site."""
    snap = _COMPILE_SECONDS.snapshot()
    return float(sum(series["sum"] for series in snap["series"]))


# --------------------------------------------------------------------------- #
# memory accounting
# --------------------------------------------------------------------------- #


def note_host_staging(site: str, nbytes: int) -> None:
    """Record the streaming executor's two host staging buffers: the live
    gauge and the peak per site."""
    if not resources_enabled():
        return
    nbytes = int(nbytes)
    _HOST_STAGING.set(nbytes, site=site)
    with _LOCK:
        if nbytes > _STAGING_PEAK.get(site, 0):
            _STAGING_PEAK[site] = nbytes


def peak_host_staging_bytes(site: Optional[str] = None) -> int:
    """Peak host staging bytes: of one site, or the largest of all."""
    with _LOCK:
        if site is not None:
            return _STAGING_PEAK.get(site, 0)
        return max(_STAGING_PEAK.values(), default=0)


def _platform() -> str:
    """The backend as JAX names platforms: ``gpu`` with a card, else ``cpu``."""
    import torch

    return "gpu" if torch.cuda.is_available() else "cpu"


def plane_placement(platform: Optional[str] = None) -> str:
    """``device`` on an accelerator platform (``gpu``, ``tpu``), else
    ``host``; with no platform named, this process's backend."""
    if platform is None:
        platform = _platform()
    return "device" if platform in ("tpu", "gpu") else "host"


# feature-id widths of the JAX package's narrowed feature table
# (``isoforest_tpu/ops/scoring_layout.py::feature_dtype``)
_I8_MAX_FEATURES = 128
_I16_MAX_FEATURES = 32768


def _layout_nbytes(model) -> int:
    """The JAX package's ``fleet.registry.layout_nbytes`` for the same
    model: the bytes of its finalized layout (f32: the ``[T, M, 2]``
    record, the value plane and the narrowed feature table; EIF: the ``[T,
    M, 1 + 2k]`` record and the value plane), or of the q16 plane for a
    model that prefers it."""
    from ..ops.ext_growth import ExtendedForest
    from ..ops.scoring_layout import layout_nbytes
    from ..ops.traversal import scoring_tables
    from ..utils.validation import UNKNOWN_TOTAL_NUM_FEATURES

    forest = model.forest
    if getattr(model, "scoring_representation", "f32") == "q16":
        return layout_nbytes(scoring_tables(forest, "q16", model.device, model._cache))
    slots = forest.num_trees * forest.max_nodes
    if isinstance(forest, ExtendedForest):
        k = int(forest.indices.shape[2])
        return slots * (1 + 2 * k) * 4 + slots * 4
    width = model.total_num_features
    if width == UNKNOWN_TOTAL_NUM_FEATURES:
        feature_bytes = 4
    elif width <= _I8_MAX_FEATURES:
        feature_bytes = 1
    elif width <= _I16_MAX_FEATURES:
        feature_bytes = 2
    else:
        feature_bytes = 4
    return slots * (2 * 4 + 4 + feature_bytes)


def model_plane_bytes(model, platform: Optional[str] = None) -> dict:
    """A model's resident representation bytes split host/device:
    ``{"host", "device", "plane", "placement"}``. The bytes are the JAX
    package's for the same model; the placement is ``device`` when the
    model's tensors are on the card (or ``platform`` names an
    accelerator)."""
    nbytes = int(_layout_nbytes(model))
    if platform is None:
        platform = "gpu" if model.device.type == "cuda" else "cpu"
    placement = plane_placement(platform)
    return {
        "host": nbytes,
        "device": nbytes if placement == "device" else 0,
        "plane": getattr(model, "scoring_representation", "f32"),
        "placement": placement,
    }


def account_resident_plane(model_id: str, host_bytes: int, device_bytes: int, plane: str = "f32") -> None:
    """Register one resident model's plane bytes; the totals land on the
    ``isoforest_resident_plane_bytes{placement}`` gauges."""
    with _LOCK:
        _PLANES[str(model_id)] = {"host": int(host_bytes), "device": int(device_bytes), "plane": str(plane)}
        totals = _plane_totals_locked()
    _RESIDENT_PLANE.set(totals["host"], placement="host")
    _RESIDENT_PLANE.set(totals["device"], placement="device")


def release_resident_plane(model_id: str) -> None:
    """Drop one model's plane accounting."""
    with _LOCK:
        _PLANES.pop(str(model_id), None)
        totals = _plane_totals_locked()
    _RESIDENT_PLANE.set(totals["host"], placement="host")
    _RESIDENT_PLANE.set(totals["device"], placement="device")


def _plane_totals_locked() -> Dict[str, int]:
    return {
        "host": sum(p["host"] for p in _PLANES.values()),
        "device": sum(p["device"] for p in _PLANES.values()),
    }


def resident_plane_bytes() -> dict:
    """Current plane-byte totals and the per-model breakdown."""
    with _LOCK:
        totals = _plane_totals_locked()
        models = {mid: dict(p) for mid, p in sorted(_PLANES.items())}
    return {"host": totals["host"], "device": totals["device"], "models": models}


def memory_watermarks() -> dict:
    """The memory section of the flight recorder: staging watermarks per
    site and the resident-plane totals; every key is present (zeros before
    any streamed run or resident model)."""
    with _LOCK:
        staging = {
            site: {"current_bytes": int(_HOST_STAGING.value(site=site)), "peak_bytes": peak}
            for site, peak in sorted(_STAGING_PEAK.items())
        }
    return {
        "host_staging": staging,
        "host_staging_peak_bytes": peak_host_staging_bytes(),
        "resident_plane_bytes": resident_plane_bytes(),
    }


# --------------------------------------------------------------------------- #
# flight recorder
# --------------------------------------------------------------------------- #

# every key build_bundle() always emits: the JAX package's schema
BUNDLE_SECTIONS = (
    "schema",
    "generated_unix_s",
    "config",
    "traces",
    "events",
    "metrics",
    "degradations",
    "autotune",
    "compile_log",
    "compiles",
    "memory",
)


def config_fingerprint() -> dict:
    """What this process is: versions (torch and CUDA where the JAX package
    names jax), the backend (``gpu`` or ``cpu``, as JAX names platforms),
    every ``ISOFOREST_TPU_*`` variable and argv."""
    import torch

    from .. import __version__

    return {
        "package_version": __version__,
        "python": sys.version.split()[0],
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "backend": _platform(),
        "pid": os.getpid(),
        "argv": list(sys.argv),
        "env": {k: v for k, v in sorted(os.environ.items()) if k.startswith("ISOFOREST_TPU_")},
    }


def build_bundle(trace_limit: int = 10, event_tail: int = 200) -> dict:
    """Assemble the one-file postmortem artifact (plain JSON types) with
    exactly the sections of :data:`BUNDLE_SECTIONS`, and any registered
    provider's; containers are present even when empty."""
    from ..resilience import degradation as _degradation
    from . import events as _events
    from . import metrics as _metrics
    from . import spans as _spans

    try:
        from ..tuning import decision_counts, table_snapshot

        autotune = {"table": table_snapshot(), "decisions": decision_counts()}
    except Exception as exc:  # a broken table must not kill the bundle
        autotune = {"error": repr(exc)}
    timeline = [e.as_dict() for e in _events.get_events()]
    doc = {
        "schema": BUNDLE_SCHEMA,
        "generated_unix_s": round(time.time(), 3),
        "config": config_fingerprint(),
        "traces": _spans.recent_traces(limit=trace_limit),
        "events": timeline[-event_tail:],
        "metrics": _metrics.registry().snapshot(),
        "degradations": {
            "ladder": sorted(_degradation.LADDER),
            "events": [d.as_dict() for d in _degradation.degradations()],
        },
        "autotune": autotune,
        "compile_log": compile_log(),
        "compiles": compile_counts(),
        "memory": memory_watermarks(),
    }
    with _LOCK:
        providers = dict(_BUNDLE_PROVIDERS)
    for name, provider in sorted(providers.items()):
        try:
            doc[name] = provider()
        except Exception as exc:  # a broken provider must not kill the bundle
            doc[name] = {"error": repr(exc)}
    return doc


# sections of subsystems that only sometimes live in the process: a
# zero-argument provider whose output rides every bundle while registered
_BUNDLE_PROVIDERS: dict = {}


def register_bundle_section(name: str, provider) -> None:
    """Attach ``provider()``'s output as section ``name`` of every later bundle."""
    with _LOCK:
        _BUNDLE_PROVIDERS[str(name)] = provider


def unregister_bundle_section(name: str) -> None:
    with _LOCK:
        _BUNDLE_PROVIDERS.pop(str(name), None)


def write_bundle(path: str, **kw) -> dict:
    """Build the bundle, write it to ``path`` as JSON and return it."""
    doc = build_bundle(**kw)
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=2, sort_keys=True)
        fh.write("\n")
    return doc


def reset_resources() -> None:
    """Clear the compile log, the watermarks and the plane accounting, and
    reset the phase to ``warmup`` (metric series are cleared by
    ``reset_metrics``)."""
    global _PHASE
    with _LOCK:
        _COMPILE_LOG.clear()
        _STAGING_PEAK.clear()
        _PLANES.clear()
    _PHASE = "warmup"


# registration is once a process and the listener costs next to nothing
# with the plane off, so every entry point is covered without ceremony
install_compile_listener()

__all__ = [
    "BUNDLE_SCHEMA",
    "BUNDLE_SECTIONS",
    "COMPILE_LOG_MAX",
    "account_resident_plane",
    "build_bundle",
    "compile_counts",
    "compile_log",
    "compile_scope",
    "compile_seconds_total",
    "config_fingerprint",
    "current_phase",
    "disable_resources",
    "enable_resources",
    "install_compile_listener",
    "mark_steady",
    "mark_warmup",
    "memory_watermarks",
    "model_plane_bytes",
    "note_host_staging",
    "peak_host_staging_bytes",
    "plane_placement",
    "register_bundle_section",
    "release_resident_plane",
    "reset_resources",
    "resident_plane_bytes",
    "resources_enabled",
    "unregister_bundle_section",
    "warmup_scope",
    "write_bundle",
]
