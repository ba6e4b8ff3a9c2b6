"""Out-of-core scoring: a sharded source scored shard by shard into sealed
parts (``isoforest_tpu/io/outofcore.py``).

:func:`score_source` scores each shard of a source chunk by chunk through
``model.score`` (the streaming executor and the kernels on the card; each
chunk's scores come back to the host once) and seals them as one atomic
part directory (``part-00007/`` with ``scores.npy``, ``part.json`` and
``_MANIFEST.json``) under the sink. Scoring is row-independent and chunking
does not change a score, so a sealed part is a function of (model, shard,
strategy): a killed run run again with ``resume=True`` skips every intact
part and ends with output byte-equal to an uninterrupted run's. A
``fingerprint.json`` gate (the model's hash, the source's shards, the
strategy) refuses a resume against another model, source or strategy; the
requested strategy string takes part because strategies are each
deterministic but not equal to one another (``"auto"`` resolves per box;
a named strategy makes the sink portable).

The sink's layout, fingerprint and model hash are the JAX package's, so a
sink either package sealed halfway resumes in the other, under a strategy
both serve (``walk`` or ``dense``; the port refuses the JAX package's
``gather``, ``pallas`` and ``native``).

Memory: one decoded chunk and one shard's scores at a time.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Optional

import numpy as np

from ..ops.traversal import check_strategy_name
from ..resilience import faults, manifest
from ..resilience.checkpoint import CheckpointMismatchError
from ..telemetry.events import record_event
from ..telemetry.metrics import counter as _telemetry_counter
from ..utils.validation import logger
from .persistence import _atomic_dir
from .source import ShardedSource, open_source

FINGERPRINT_NAME = "fingerprint.json"
SUMMARY_NAME = "_SUMMARY.json"
SINK_VERSION = 1

_SHARDS_SEALED_TOTAL = _telemetry_counter(
    "isoforest_score_source_shards_sealed_total",
    "Source shards whose scores were sealed by out-of-core scoring runs",
)


def _part_name(index: int) -> str:
    return f"part-{index:05d}"


def model_fingerprint(model) -> str:
    """sha256 of what determines a score: the forest's arrays (by field
    name, shape, dtype and C-order bytes, from a host copy), the ensemble's
    ``numSamples`` and the threshold; equal to the JAX package's for the
    same model."""
    h = hashlib.sha256()
    forest = model.forest
    for field in type(forest)._fields:
        arr = getattr(forest, field).cpu().numpy()
        h.update(field.encode())
        h.update(repr((arr.shape, str(arr.dtype))).encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    h.update(repr((int(model.num_samples), float(model.outlier_score_threshold))).encode())
    return h.hexdigest()


def _sink_fingerprint(model, source: ShardedSource, strategy: str) -> dict:
    return {
        "sinkVersion": SINK_VERSION,
        "modelSha256": model_fingerprint(model),
        "strategy": str(strategy),
        "source": source.fingerprint(),
    }


def _write_json(path: str, payload: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(payload, fh, indent=1, sort_keys=True)
        fh.write("\n")
    os.replace(tmp, path)


def _load_sealed_part(sink_dir: str, index: int, shard) -> Optional[np.ndarray]:
    """The sealed scores of shard ``index`` if its part is intact and names
    this shard, else None (the shard is scored again)."""
    part_dir = os.path.join(sink_dir, _part_name(index))
    if not os.path.isdir(part_dir) or not manifest.present(part_dir):
        return None
    if manifest.verify(part_dir):
        logger.warning("out-of-core sink: sealed part %s failed manifest verification; re-scoring shard", part_dir)
        return None
    try:
        with open(os.path.join(part_dir, "part.json")) as fh:
            meta = json.load(fh)
        if (meta.get("shardIndex") != index or meta.get("shardName") != shard.name
                or meta.get("sizeBytes") != shard.size_bytes):
            return None
        return np.load(os.path.join(part_dir, "scores.npy"))
    except (OSError, ValueError):
        return None


def _check_sink(sink_dir: str, fingerprint: dict, resume: bool) -> None:
    """Write the sink's fingerprint, or check the one there: another model,
    source or strategy raises, and so do sealed parts without ``resume``."""
    fp_path = os.path.join(sink_dir, FINGERPRINT_NAME)
    if not os.path.exists(fp_path):
        _write_json(fp_path, fingerprint)
        return
    with open(fp_path) as fh:
        existing = json.load(fh)
    if existing != fingerprint:
        mismatched = sorted(k for k in set(existing) | set(fingerprint) if existing.get(k) != fingerprint.get(k))
        raise CheckpointMismatchError(
            f"out-of-core sink {sink_dir!r} was written for a different "
            f"{'/'.join(mismatched)}; refusing to {'resume' if resume else 'overwrite'} "
            "(use a fresh sink directory)",
            mismatched_fields=mismatched,
        )
    if not resume:
        sealed = [name for name in os.listdir(sink_dir)
                  if name.startswith("part-") and manifest.present(os.path.join(sink_dir, name))]
        if sealed:
            raise CheckpointMismatchError(
                f"out-of-core sink {sink_dir!r} already holds {len(sealed)} sealed part(s); pass "
                "resume=True to continue it or use a fresh sink directory",
                mismatched_fields=["resume"],
            )


def _seal_part(sink_dir: str, index: int, shard, scores: np.ndarray) -> None:
    with _atomic_dir(os.path.join(sink_dir, _part_name(index)), overwrite=True) as tmp:
        np.save(os.path.join(tmp, "scores.npy"), scores)
        with open(os.path.join(tmp, "part.json"), "w") as fh:
            json.dump({"shardIndex": index, "shardName": shard.name, "sizeBytes": shard.size_bytes,
                       "rows": int(scores.shape[0])}, fh, indent=1, sort_keys=True)
            fh.write("\n")
        manifest.write(tmp)


def score_source(model, source, sink_dir: str, *, chunk_rows: Optional[int] = None, strategy: str = "auto",
                 pipeline: Optional[bool] = None, resume: bool = False) -> dict:
    """Score every row of ``source`` (a path, glob or
    :class:`~.source.ShardedSource`) into ``sink_dir``, one sealed part per
    shard, in chunks of ``chunk_rows`` (default
    :data:`~.source.DEFAULT_CHUNK_ROWS`), each one ``model.score`` call
    with ``strategy`` and ``pipeline``. Returns the run's summary, also
    written as ``_SUMMARY.json``.

    ``resume=True`` continues an existing sink: its fingerprint must match
    (else :class:`~..resilience.checkpoint.CheckpointMismatchError`), intact
    sealed parts are skipped, and the output equals an uninterrupted run's
    byte for byte. Without ``resume`` a sink that holds sealed parts is
    refused. A strategy the port does not serve raises before the sink is
    touched.
    """
    check_strategy_name(strategy)
    src = open_source(source)
    fingerprint = _sink_fingerprint(model, src, strategy)
    os.makedirs(sink_dir, exist_ok=True)
    _check_sink(sink_dir, fingerprint, resume)

    t0 = time.perf_counter()
    record_event("score_source.begin", sink=os.path.basename(os.path.normpath(sink_dir)), shards=src.num_shards,
                 resume=bool(resume), strategy=str(strategy))
    total_rows = sealed_now = skipped = 0
    shard_seconds = []
    for index, shard in enumerate(src.shards):
        if resume:
            scores = _load_sealed_part(sink_dir, index, shard)
            if scores is not None:
                total_rows += int(scores.shape[0])
                skipped += 1
                record_event("score_source.shard_skipped", shard=index, rows=int(scores.shape[0]))
                continue
        t_shard = time.perf_counter()
        parts = [
            model.score(chunk.X, strategy=strategy, chunk_size=chunk_rows, pipeline=pipeline,
                        nonfinite="allow").cpu().numpy()
            for chunk in src.iter_chunks(chunk_rows=chunk_rows, start_shard=index, stop_shard=index + 1)
        ]
        if not parts:
            scores = np.zeros((0,), dtype=np.float32)
        else:
            scores = np.concatenate(parts) if len(parts) != 1 else parts[0]
        _seal_part(sink_dir, index, shard, scores)
        elapsed = time.perf_counter() - t_shard
        shard_seconds.append(elapsed)
        total_rows += int(scores.shape[0])
        sealed_now += 1
        _SHARDS_SEALED_TOTAL.inc()
        record_event("score_source.shard_sealed", shard=index, rows=int(scores.shape[0]), seconds=round(elapsed, 6))
        faults.check_score_shard(index)  # a kill lands after the seal

    seconds = time.perf_counter() - t0
    summary = {
        "shards": src.num_shards,
        "sealed": sealed_now,
        "skipped": skipped,
        "rows": total_rows,
        "seconds": round(seconds, 6),
        "rowsPerSecond": round(total_rows / seconds, 3) if seconds > 0 else None,
        "shardSecondsMean": round(sum(shard_seconds) / len(shard_seconds), 6) if shard_seconds else None,
        "strategy": str(strategy),
    }
    _write_json(os.path.join(sink_dir, SUMMARY_NAME), summary)
    record_event("score_source.complete", rows=total_rows, sealed=sealed_now, skipped=skipped,
                 seconds=round(seconds, 6))
    logger.info("out-of-core scoring: %d rows over %d shard(s) (%d sealed now, %d resumed) in %.3fs",
                total_rows, src.num_shards, sealed_now, skipped, seconds)
    return summary


def read_scores(sink_dir: str, num_shards: Optional[int] = None) -> np.ndarray:
    """The sealed scores of a completed sink, concatenated in shard order.
    Raises if a part is missing (``num_shards`` checks the count), unsealed
    or fails its manifest."""
    names = sorted(name for name in os.listdir(sink_dir)
                   if name.startswith("part-") and os.path.isdir(os.path.join(sink_dir, name)))
    if num_shards is not None and len(names) != num_shards:
        raise FileNotFoundError(f"sink {sink_dir!r} holds {len(names)} part(s), expected {num_shards}")
    if not names:
        raise FileNotFoundError(f"sink {sink_dir!r} holds no sealed parts")
    parts = []
    for name in names:
        part_dir = os.path.join(sink_dir, name)
        if not manifest.present(part_dir):
            raise FileNotFoundError(f"part {part_dir!r} is not sealed")
        issues = manifest.verify(part_dir)
        if issues:
            raise ValueError(f"part {part_dir!r} fails verification: {issues}")
        parts.append(np.load(os.path.join(part_dir, "scores.npy")))
    return np.concatenate(parts) if len(parts) > 1 else parts[0]
