"""Block-wise fit checkpoints: a fit that survives preemption and resumes
bitwise (``isoforest_tpu/resilience/checkpoint.py``).

A checkpointed fit grows the forest in blocks of trees and seals each
completed block on disk, so a killed fit resumes from its last sealed
block. The resume is bitwise: tree ``t`` grows from its own key and its
slice of the ensemble's bags and feature subsets, which the fit draws once
for the whole ensemble and slices per block, so any block partition, in
any session, grows the same arrays.

The layout is the JAX package's, so a directory one package wrote resumes
in the other (the forest tuples have the same field names and dtypes)::

    <checkpoint_dir>/
      fingerprint.json          # config, seed and data fingerprint, written first
      block-00000/
        arrays.npz              # the block's forest arrays
        block.json              # {blockIndex, treeStart, treeStop, fingerprintSha256}
        _MANIFEST.json          # size, CRC32 and SHA-256 of each file
      block-00001/ ...

Resume rules (``fit(..., resume=True)``):

* the stored fingerprint must equal the fit's; otherwise
  :class:`CheckpointMismatchError` names the differing fields;
* a sealed, verified block with a matching ``block.json`` is loaded;
  anything else (a torn write, a corrupt npz, a wrong range) is logged and
  grown again, which is always safe;
* ``resume=False`` refuses a directory that holds sealed blocks.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..telemetry.events import record_event
from ..telemetry.metrics import counter as _counter
from ..utils.validation import logger
from . import manifest as _manifest

_BLOCKS_SEALED_TOTAL = _counter(
    "isoforest_checkpoint_blocks_sealed_total",
    "Checkpointed-fit tree blocks sealed durably this process",
)
_BLOCKS_RESUMED_TOTAL = _counter(
    "isoforest_checkpoint_blocks_resumed_total",
    "Checkpointed-fit tree blocks loaded from a previous session's seals",
)

CHECKPOINT_VERSION = 1
FINGERPRINT_NAME = "fingerprint.json"
_BLOCK_PREFIX = "block-"
_ARRAYS_NAME = "arrays.npz"
_BLOCK_META_NAME = "block.json"

# default trees per block: 4 seals of the default 100-tree ensemble, so a
# preemption loses at most 32 trees of work
DEFAULT_BLOCK_TREES = 32


class CheckpointMismatchError(ValueError):
    """The checkpoint on disk was written by a different fit configuration
    (or different training data) than the resume attempt. Carries
    ``mismatched_fields``."""

    def __init__(self, message: str, mismatched_fields: Tuple[str, ...] = ()) -> None:
        super().__init__(message)
        self.mismatched_fields = tuple(mismatched_fields)


def resolve_block_size(checkpoint_every: Optional[int], num_trees: int) -> int:
    """Trees per block: ``checkpoint_every`` clamped to the ensemble, or the
    default."""
    if checkpoint_every is None:
        return min(num_trees, DEFAULT_BLOCK_TREES)
    block = int(checkpoint_every)
    if block < 1:
        raise ValueError(f"checkpoint_every must be >= 1, got {checkpoint_every}")
    return min(block, num_trees)


def data_fingerprint(X: np.ndarray) -> str:
    """Bounded-cost content fingerprint of the host training matrix:
    shape, dtype, a <=64k-element stride sample and both edges, hashed as
    the JAX package hashes them."""
    x = np.ascontiguousarray(X)
    digest = hashlib.sha256()
    digest.update(repr((x.shape, str(x.dtype))).encode())
    flat = x.reshape(-1)
    if flat.size:
        stride = max(1, flat.size // 65536)
        digest.update(np.ascontiguousarray(flat[::stride]).tobytes())
        digest.update(flat[:64].tobytes())
        digest.update(flat[-64:].tobytes())
    return digest.hexdigest()


def fit_fingerprint(
    *,
    kind: str,
    random_seed: int,
    num_estimators: int,
    bootstrap: bool,
    num_samples: int,
    num_features: int,
    height: int,
    total_rows: int,
    total_features: int,
    block_trees: int,
    data_sha256: str,
    extension_level: Optional[int] = None,
    sampler_sha256: Optional[str] = None,
) -> Dict[str, object]:
    """Everything that determines the grown forest's bits, and the block
    partition: a resumed fit must agree on every field. ``sampler_sha256``,
    the streamed sample's hash, is set only by an out-of-core fit
    (``fit_source``), and joins as ``samplerSha256`` only then, so a plain
    fit's fingerprint stays as it was and a resume cannot mix samples."""
    out = {
        "checkpointVersion": CHECKPOINT_VERSION,
        "kind": kind,
        "randomSeed": int(random_seed),
        "numEstimators": int(num_estimators),
        "bootstrap": bool(bootstrap),
        "numSamples": int(num_samples),
        "numFeatures": int(num_features),
        "height": int(height),
        "totalRows": int(total_rows),
        "totalFeatures": int(total_features),
        "blockTrees": int(block_trees),
        "extensionLevel": None if extension_level is None else int(extension_level),
        "dataSha256": str(data_sha256),
    }
    if sampler_sha256 is not None:
        out["samplerSha256"] = str(sampler_sha256)
    return out


def _fingerprint_sha(fingerprint: Dict[str, object]) -> str:
    return hashlib.sha256(
        json.dumps(fingerprint, sort_keys=True).encode()
    ).hexdigest()


class FitCheckpoint:
    """One fit's checkpoint directory: fingerprint gate + sealed tree blocks.

    Lifecycle: construct with the current fit's fingerprint, :meth:`begin`
    (validates/initialises the directory), then per block either
    :meth:`load_block` (returns the sealed arrays or None) or grow +
    :meth:`seal_block`. ``blocks_written`` counts seals this session,
    ``blocks_loaded`` blocks resumed.
    """

    def __init__(self, directory: str, fingerprint: Dict[str, object]) -> None:
        self.directory = str(directory)
        self.fingerprint = dict(fingerprint)
        self.sha = _fingerprint_sha(self.fingerprint)
        self.blocks_written = 0
        self.blocks_loaded = 0

    # ------------------------------------------------------------------ #

    def _block_path(self, index: int) -> str:
        return os.path.join(self.directory, f"{_BLOCK_PREFIX}{index:05d}")

    def _sealed_block_names(self) -> List[str]:
        if not os.path.isdir(self.directory):
            return []
        return sorted(
            name
            for name in os.listdir(self.directory)
            if name.startswith(_BLOCK_PREFIX)
            and os.path.isdir(os.path.join(self.directory, name))
            and ".__tmp-" not in name
        )

    def begin(self, resume: bool) -> None:
        """Validate or initialise the checkpoint directory.

        A stored fingerprint must match the current fit bit for bit;
        otherwise :class:`CheckpointMismatchError` lists the differing
        fields (the actionable half: fix the config/data, resume into a
        fresh directory, or delete this one). ``resume=False`` refuses a
        directory that already holds sealed blocks."""
        os.makedirs(self.directory, exist_ok=True)
        fp_path = os.path.join(self.directory, FINGERPRINT_NAME)
        sealed = self._sealed_block_names()
        if os.path.exists(fp_path):
            try:
                with open(fp_path) as fh:
                    on_disk = json.load(fh)
            except (OSError, ValueError) as exc:
                raise CheckpointMismatchError(
                    f"checkpoint fingerprint {fp_path} is unreadable ({exc}); "
                    "the checkpoint directory is corrupt — delete it and "
                    "re-run the fit"
                ) from exc
            if on_disk != self.fingerprint:
                fields = tuple(
                    sorted(
                        k
                        for k in set(on_disk) | set(self.fingerprint)
                        if on_disk.get(k) != self.fingerprint.get(k)
                    )
                )
                raise CheckpointMismatchError(
                    f"checkpoint at {self.directory} was written by a "
                    "different fit configuration; refusing to resume "
                    "(a mismatched resume would silently produce a "
                    "different forest). Mismatched fields: "
                    + ", ".join(
                        f"{k}: checkpoint={on_disk.get(k)!r} vs "
                        f"current={self.fingerprint.get(k)!r}"
                        for k in fields
                    )
                    + ". Fix the config/data, point checkpoint_dir at a "
                    "fresh directory, or delete the stale checkpoint",
                    mismatched_fields=fields,
                )
            if not resume and sealed:
                raise CheckpointMismatchError(
                    f"checkpoint_dir {self.directory} already holds "
                    f"{len(sealed)} sealed block(s) from a previous fit; "
                    "pass resume=True to continue it, or delete the "
                    "directory to start over"
                )
        else:
            if sealed:
                raise CheckpointMismatchError(
                    f"checkpoint_dir {self.directory} holds sealed blocks "
                    "but no fingerprint — the directory is corrupt or not a "
                    "fit checkpoint; delete it and re-run the fit"
                )
            tmp = f"{fp_path}.tmp-{os.getpid()}"
            with open(tmp, "w") as fh:
                json.dump(self.fingerprint, fh, indent=1, sort_keys=True)
                fh.write("\n")
            os.replace(tmp, fp_path)
        record_event(
            "checkpoint.begin",
            directory=self.directory,
            resume=bool(resume),
            sealed_blocks=len(sealed),
        )

    # ------------------------------------------------------------------ #

    def load_block(
        self, index: int, start: int, stop: int
    ) -> Optional[Dict[str, np.ndarray]]:
        """The sealed arrays for block ``index`` covering trees
        ``[start, stop)``, or None when absent/unverifiable (the caller
        re-grows — always safe, blocks are deterministic)."""
        path = self._block_path(index)
        if not os.path.isdir(path):
            return None
        issues: List[str] = []
        if not _manifest.present(path):
            issues.append("no manifest (unsealed block)")
        else:
            issues.extend(_manifest.verify(path))
        meta = None
        if not issues:
            try:
                with open(os.path.join(path, _BLOCK_META_NAME)) as fh:
                    meta = json.load(fh)
            except (OSError, ValueError) as exc:
                issues.append(f"unreadable {_BLOCK_META_NAME} ({exc})")
        if meta is not None:
            want = {
                "blockIndex": index,
                "treeStart": start,
                "treeStop": stop,
                "fingerprintSha256": self.sha,
            }
            for key, value in want.items():
                if meta.get(key) != value:
                    issues.append(
                        f"{_BLOCK_META_NAME}: {key} is {meta.get(key)!r}, "
                        f"expected {value!r}"
                    )
        arrays: Optional[Dict[str, np.ndarray]] = None
        if not issues:
            try:
                with np.load(os.path.join(path, _ARRAYS_NAME)) as npz:
                    arrays = {name: npz[name] for name in npz.files}
            except Exception as exc:
                issues.append(f"unreadable {_ARRAYS_NAME} ({exc})")
        if issues:
            record_event(
                "checkpoint.block_regrown",
                index=index,
                start=start,
                stop=stop,
                issues="; ".join(issues),
            )
            logger.warning(
                "checkpoint block %s is unusable (%s); re-growing trees "
                "[%d, %d) — deterministic streams make regrowth lossless",
                path,
                "; ".join(issues),
                start,
                stop,
            )
            return None
        self.blocks_loaded += 1
        _BLOCKS_RESUMED_TOTAL.inc()
        record_event(
            "checkpoint.block_resumed", index=index, start=start, stop=stop
        )
        return arrays

    def seal_block(
        self, index: int, start: int, stop: int, arrays: Dict[str, np.ndarray]
    ) -> None:
        """Atomically persist one completed block: full content under a
        temp dir, ``_MANIFEST.json`` checksums, one ``os.rename``. A kill
        at any point leaves either the previous state or the sealed block —
        never a partial one (the marked temp dir a hard kill can leave is
        swept by the next seal and ignored by :meth:`load_block`)."""
        from ..io.persistence import _atomic_dir

        path = self._block_path(index)
        with _atomic_dir(path, overwrite=True) as tmp:
            np.savez(os.path.join(tmp, _ARRAYS_NAME), **arrays)
            with open(os.path.join(tmp, _BLOCK_META_NAME), "w") as fh:
                json.dump(
                    {
                        "checkpointVersion": CHECKPOINT_VERSION,
                        "blockIndex": int(index),
                        "treeStart": int(start),
                        "treeStop": int(stop),
                        "fingerprintSha256": self.sha,
                    },
                    fh,
                    indent=1,
                    sort_keys=True,
                )
                fh.write("\n")
        self.blocks_written += 1
        _BLOCKS_SEALED_TOTAL.inc()
        record_event(
            "checkpoint.block_sealed", index=index, start=start, stop=stop
        )


def block_ranges(num_trees: int, block_trees: int) -> List[Tuple[int, int, int]]:
    """``[(block index, tree start, tree stop), ...]`` covering the ensemble."""
    out = []
    for index, start in enumerate(range(0, num_trees, block_trees)):
        out.append((index, start, min(num_trees, start + block_trees)))
    return out
