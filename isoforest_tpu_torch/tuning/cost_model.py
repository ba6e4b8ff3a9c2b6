"""Persistent measured cost model behind ``strategy="auto"``
(``isoforest_tpu/tuning/cost_model.py``).

The table maps a decision key (``(platform, model-shape bucket, batch
bucket, extended?)`` rendered as one string, :func:`~.autotuner.decision_key`)
to the strategy that *measured* fastest for that regime, with the probe
timings that chose it. It is persisted as schema-versioned JSON, so a cold
probe is paid once per TTL window per fleet of processes::

    {"schema": 1,
     "entries": {
       "<key>": {"strategy": "walk",
                 "timings_s": {"walk": 0.0021, "dense": 0.0098},
                 "probe_rows": 262144, "reps": 2, "unix_s": 1754300000.0}}}

The environment variables are the JAX package's:
``ISOFOREST_TPU_AUTOTUNE_PATH`` names the file and
``ISOFOREST_TPU_AUTOTUNE_TTL_S`` the age (default a day) past which an entry
reads as a miss and the next ``auto`` resolution re-probes. The default path
is the port's own, ``isoforest_tpu_torch_autotune.json`` in the temp dir:
two packages rewriting one table would clobber each other's entries.

A corrupt file, an unknown schema version or a non-dict document is refused:
the table starts empty (the next probe overwrites the bad file) with a
one-shot warning. Writes re-read the file and merge per entry (newest
``unix_s`` wins) before an atomic replace, so two processes probing
different keys both land; readers re-stat the file at most once per
:data:`_RELOAD_EVERY_S`.
"""

from __future__ import annotations

import json
import os
import pathlib
import tempfile
import threading
import time
from typing import Dict, Optional, Tuple

from ..telemetry.events import record_event
from ..utils.validation import logger

SCHEMA_VERSION = 1
DEFAULT_TTL_S = 86_400.0

# readers re-stat the table file at most this often (serving loops resolve
# per batch; a stat per call would be pure overhead)
_RELOAD_EVERY_S = 5.0


def table_path() -> pathlib.Path:
    """Resolved table location: ``ISOFOREST_TPU_AUTOTUNE_PATH``, else the
    port's own file in the temp dir. Read per call so tests can re-point it."""
    env = os.environ.get("ISOFOREST_TPU_AUTOTUNE_PATH")
    if env:
        return pathlib.Path(env)
    return pathlib.Path(tempfile.gettempdir()) / "isoforest_tpu_torch_autotune.json"


def ttl_s() -> float:
    try:
        return float(os.environ.get("ISOFOREST_TPU_AUTOTUNE_TTL_S", DEFAULT_TTL_S))
    except ValueError:
        return DEFAULT_TTL_S


def _valid_entry(entry: object) -> bool:
    return (
        isinstance(entry, dict)
        and isinstance(entry.get("strategy"), str)
        and isinstance(entry.get("unix_s"), (int, float))
    )


class CostModel:
    """In-memory view of the persisted winner table (one per process)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._entries: Dict[str, dict] = {}
        self._loaded_path: Optional[pathlib.Path] = None
        self._loaded_stat: Optional[Tuple[float, int]] = None
        self._next_stat_s = 0.0
        self._warned_invalid = False

    # -- file I/O ---------------------------------------------------------

    def _read_file(self, path: pathlib.Path) -> Optional[Dict[str, dict]]:
        """Parse + validate the persisted document; None when absent or
        refused (corrupt / wrong schema — warned once, rebuilt clean)."""
        try:
            with open(path) as fh:
                doc = json.load(fh)
        except FileNotFoundError:
            return None
        except (OSError, ValueError) as exc:
            self._refuse(path, f"unreadable/corrupt ({type(exc).__name__}: {exc})")
            return None
        if not isinstance(doc, dict) or doc.get("schema") != SCHEMA_VERSION:
            got = doc.get("schema") if isinstance(doc, dict) else type(doc).__name__
            self._refuse(path, f"schema {got!r} != {SCHEMA_VERSION}")
            return None
        entries = doc.get("entries")
        if not isinstance(entries, dict):
            self._refuse(path, "no 'entries' mapping")
            return None
        return {k: v for k, v in entries.items() if _valid_entry(v)}

    def _refuse(self, path: pathlib.Path, why: str) -> None:
        if not self._warned_invalid:
            self._warned_invalid = True
            logger.warning(
                "autotune table %s refused (%s); rebuilding from fresh probes",
                path,
                why,
            )
        record_event("autotune.table_rejected", path=str(path), reason=why)

    def _maybe_reload_locked(self, force: bool = False) -> None:
        path = table_path()
        now = time.monotonic()
        if path != self._loaded_path:
            force = True
        if not force and now < self._next_stat_s:
            return
        self._next_stat_s = now + _RELOAD_EVERY_S
        try:
            st = os.stat(path)
            stat_key = (st.st_mtime, st.st_size)
        except OSError:
            stat_key = None
        if not force and stat_key == self._loaded_stat:
            return
        entries = self._read_file(path)
        self._entries = entries if entries is not None else {}
        self._loaded_path = path
        self._loaded_stat = stat_key

    # -- API --------------------------------------------------------------

    def lookup(self, key: str, now: Optional[float] = None) -> Tuple[Optional[dict], bool]:
        """``(entry, fresh)`` for a key: entry is None on a miss; ``fresh``
        is False when the entry exists but has aged past the TTL (the
        caller re-probes and records the refresh)."""
        now = time.time() if now is None else now
        with self._lock:
            self._maybe_reload_locked()
            entry = self._entries.get(key)
        if entry is None:
            return None, False
        age = now - float(entry["unix_s"])
        return dict(entry), 0 <= age <= ttl_s()

    def store(self, key: str, entry: dict) -> None:
        """Merge one probed entry into memory AND the persisted file
        (read-merge-replace; newest ``unix_s`` wins per key)."""
        path = table_path()
        with self._lock:
            self._maybe_reload_locked(force=True)
            merged = dict(self._entries)
            prior = merged.get(key)
            if prior is None or float(prior["unix_s"]) <= float(entry["unix_s"]):
                merged[key] = dict(entry)
            self._entries = merged
            doc = {"schema": SCHEMA_VERSION, "entries": merged}
            tmp = f"{path}.tmp-{os.getpid()}"
            try:
                path.parent.mkdir(parents=True, exist_ok=True)
                with open(tmp, "w") as fh:
                    json.dump(doc, fh, sort_keys=True)
                os.replace(tmp, path)
                st = os.stat(path)
                self._loaded_stat = (st.st_mtime, st.st_size)
                self._loaded_path = path
            except OSError as exc:
                # read-only tmp dir: the in-memory table still serves this
                # process; the fleet just re-probes
                logger.warning("autotune table %s unwritable: %s", path, exc)

    def snapshot(self) -> dict:
        """The full persisted document (fresh read merged over memory)."""
        with self._lock:
            self._maybe_reload_locked(force=True)
            return {
                "schema": SCHEMA_VERSION,
                "path": str(table_path()),
                "ttl_s": ttl_s(),
                "entries": {k: dict(v) for k, v in sorted(self._entries.items())},
            }

    def clear(self) -> bool:
        """Drop the in-memory table and delete the file; True if a file
        existed."""
        with self._lock:
            self._entries = {}
            self._loaded_stat = None
            try:
                os.unlink(table_path())
                return True
            except FileNotFoundError:
                return False


_MODEL = CostModel()
_MODEL_LOCK = threading.Lock()


def cost_model() -> CostModel:
    return _MODEL


def reset_cost_model() -> None:
    """Forget all in-memory state (tests re-point the table via env)."""
    global _MODEL
    with _MODEL_LOCK:
        _MODEL = CostModel()
