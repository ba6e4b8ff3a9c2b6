"""Save and load models in the reference's on-disk layout
(``isoforest_tpu/io/persistence.py``).

A model directory holds ``metadata/part-00000`` (one JSON line: class,
uid, paramMap, outlierScoreThreshold, numSamples, numFeatures,
totalNumFeatures) and ``data/*.avro``, one row per node, ``(treeID,
nodeData)`` or ``(treeID, extendedNodeData)`` with pre-order ids and ``-1``
sentinels (IsolationForestModelReadWrite.scala:82-132), and, for a model
that carries a drift baseline, the ``_BASELINE.json`` sidecar
(:mod:`..telemetry.monitor`). The heap-tensor forest is written in
pre-order and rebuilt on load, so each package loads what the other saves.

A save builds the whole directory under a sibling temporary name
(``<path>.__tmp-<hex>``), seals it with ``_MANIFEST.json``
(:mod:`..resilience.manifest`) and renames it into place, so no reader sees
a partial model; a load refuses such a temporary directory and verifies a
present manifest before it reads a byte of Avro. ``on_corrupt="drop"``
salvages what it can of a directory whose data files are damaged: the
trees that decode and validate are kept, the rest are dropped and reported
(``model.load_report``, the ``dropped_trees`` rung).
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import time
import uuid
from typing import List, Tuple

import numpy as np
import torch

from ..ops.ext_growth import ExtendedForest
from ..ops.tree_growth import StandardForest
from ..resilience import manifest as _manifest
from ..resilience.degradation import LoadReport, degrade
from ..utils.device import resolve_device
from ..utils.params import ExtendedIsolationForestParams, IsolationForestParams
from ..utils.validation import UNKNOWN_TOTAL_NUM_FEATURES, logger
from . import avro

SPARK_VERSION_STRING = "3.5.5"  # the layout's version tag in metadata

STANDARD_MODEL_CLASS = "com.linkedin.relevance.isolationforest.IsolationForestModel"
EXTENDED_MODEL_CLASS = "com.linkedin.relevance.isolationforest.extended.ExtendedIsolationForestModel"
STANDARD_ESTIMATOR_CLASS = "com.linkedin.relevance.isolationforest.IsolationForest"
EXTENDED_ESTIMATOR_CLASS = "com.linkedin.relevance.isolationforest.extended.ExtendedIsolationForest"

# The node table's schema, as spark-avro writes the reference's.
STANDARD_SCHEMA = {
    "type": "record",
    "name": "topLevelRecord",
    "fields": [
        {"name": "treeID", "type": "int"},
        {
            "name": "nodeData",
            "type": [
                {
                    "type": "record",
                    "name": "nodeData",
                    "namespace": ".nodeData",
                    "fields": [
                        {"name": "id", "type": "int"},
                        {"name": "leftChild", "type": "int"},
                        {"name": "rightChild", "type": "int"},
                        {"name": "splitAttribute", "type": "int"},
                        {"name": "splitValue", "type": "double"},
                        {"name": "numInstances", "type": "long"},
                    ],
                },
                "null",
            ],
        },
    ],
}

EXTENDED_SCHEMA = {
    "type": "record",
    "name": "topLevelRecord",
    "fields": [
        {"name": "treeID", "type": "int"},
        {
            "name": "extendedNodeData",
            "type": [
                {
                    "type": "record",
                    "name": "extendedNodeData",
                    "namespace": "topLevelRecord",
                    "fields": [
                        {"name": "id", "type": "int"},
                        {"name": "leftChild", "type": "int"},
                        {"name": "rightChild", "type": "int"},
                        {"name": "indices", "type": [{"type": "array", "items": "int"}, "null"]},
                        {"name": "weights", "type": [{"type": "array", "items": "float"}, "null"]},
                        {"name": "offset", "type": "double"},
                        {"name": "numInstances", "type": "long"},
                    ],
                },
                "null",
            ],
        },
    ],
}

# The temporary directory's marker: a save writes <path>.__tmp-<hex>, then
# renames it to <path> in one os.rename.
_TMP_MARKER = ".__tmp-"

# A tree of depth d takes 2^(d+1)-1 heap slots. Trees the reference grows
# have depth <= ceil(log2(maxSamples)), under 21 even at maxSamples = 10^6;
# a corrupt node table encoding a deep chain would force a 2^depth allocation.
_MAX_TREE_DEPTH = 24


def _check_depth(depth: int) -> None:
    if depth > _MAX_TREE_DEPTH:
        raise ValueError(
            f"refusing to materialise a tree of depth {depth} (> {_MAX_TREE_DEPTH}): "
            f"the implicit-heap layout would need 2^{depth + 1} slots; "
            "the node table is corrupt or not a valid isolation-forest model"
        )


def standard_tree_to_records(feature, threshold, num_instances) -> List[dict]:
    """One tree's heap arrays -> pre-order node records, with the sentinels
    of IsolationForestModelReadWrite.scala:36-67."""
    records: List[dict] = []

    def walk(slot: int) -> int:
        my_id = len(records)
        records.append(None)  # reserve the pre-order position
        if feature[slot] >= 0:
            left = walk(2 * slot + 1)
            right = walk(2 * slot + 2)
            records[my_id] = {
                "id": my_id, "leftChild": left, "rightChild": right,
                "splitAttribute": int(feature[slot]), "splitValue": float(threshold[slot]),
                "numInstances": -1,
            }
        else:
            records[my_id] = {
                "id": my_id, "leftChild": -1, "rightChild": -1, "splitAttribute": -1,
                "splitValue": 0.0, "numInstances": int(num_instances[slot]),
            }
        return my_id

    walk(0)
    return records


def extended_tree_to_records(indices, weights, offset, num_instances) -> List[dict]:
    """One EIF tree's heap arrays -> pre-order node records: a leaf has
    empty ``indices``/``weights`` and offset 0.0, and an internal node's
    ``(-1, 0.0)`` padding is dropped (ExtendedIsolationForestModelReadWrite.scala:33-35)."""
    records: List[dict] = []

    def walk(slot: int) -> int:
        my_id = len(records)
        records.append(None)  # reserve the pre-order position
        if indices[slot, 0] >= 0:
            left = walk(2 * slot + 1)
            right = walk(2 * slot + 2)
            valid = indices[slot] >= 0
            records[my_id] = {
                "id": my_id, "leftChild": left, "rightChild": right,
                "indices": [int(v) for v in indices[slot][valid]],
                "weights": [float(v) for v in weights[slot][valid]],
                "offset": float(offset[slot]), "numInstances": -1,
            }
        else:
            records[my_id] = {
                "id": my_id, "leftChild": -1, "rightChild": -1, "indices": [], "weights": [],
                "offset": 0.0, "numInstances": int(num_instances[slot]),
            }
        return my_id

    walk(0)
    return records


def _assign_heap_slots(records: List[dict]) -> Tuple[dict, int]:
    """Pre-order records -> ({node id: heap slot}, depth); validates
    contiguous ids (IsolationForestModelReadWrite.scala:179-205)."""
    by_id = {r["id"]: r for r in records}
    if sorted(by_id) != list(range(len(records))):
        raise ValueError("corrupt model data: node ids are not 0..N-1")
    slots: dict = {}
    max_depth = 0
    stack = [(0, 0, 0)]  # (node id, heap slot, depth)
    while stack:
        rid, slot, depth = stack.pop()
        _check_depth(depth)  # in the loop: ends cycles and deep chains alike
        slots[rid] = slot
        max_depth = max(max_depth, depth)
        r = by_id[rid]
        if r["leftChild"] >= 0:
            stack.append((r["leftChild"], 2 * slot + 1, depth + 1))
            stack.append((r["rightChild"], 2 * slot + 2, depth + 1))
    return slots, max_depth


def records_to_standard_forest(trees: List[List[dict]]) -> StandardForest:
    """Per-tree pre-order node records -> a CPU :class:`StandardForest`."""
    slot_maps, depths = [], []
    for records in trees:
        slots, depth = _assign_heap_slots(records)
        slot_maps.append(slots)
        depths.append(depth)
    height = max(depths) if depths else 0
    _check_depth(height)
    m = 2 ** (height + 1) - 1
    t = len(trees)
    feature = torch.full((t, m), -1, dtype=torch.int32)
    threshold = torch.zeros((t, m), dtype=torch.float32)
    num_instances = torch.full((t, m), -1, dtype=torch.int32)
    for ti, records in enumerate(trees):
        slots = slot_maps[ti]
        internal = [(slots[r["id"]], r) for r in records if r["leftChild"] >= 0]
        leaves = [(slots[r["id"]], r) for r in records if r["leftChild"] < 0]
        if internal:
            idx = torch.tensor([s for s, _ in internal], dtype=torch.long)
            feature[ti, idx] = torch.tensor([r["splitAttribute"] for _, r in internal], dtype=torch.int32)
            # Double split values round to float32, as the JAX package stores them
            threshold[ti, idx] = torch.tensor(
                [r["splitValue"] for _, r in internal], dtype=torch.float64
            ).to(torch.float32)
        idx = torch.tensor([s for s, _ in leaves], dtype=torch.long)
        num_instances[ti, idx] = torch.tensor([r["numInstances"] for _, r in leaves], dtype=torch.int32)
    return StandardForest(feature=feature, threshold=threshold, num_instances=num_instances)


def records_to_extended_forest(trees: List[List[dict]]) -> ExtendedForest:
    """Per-tree pre-order extended node records -> a CPU :class:`ExtendedForest`
    (``records_to_extended_forest`` :344).

    ``k`` is the widest internal node's coordinate count; narrower nodes
    keep ``-1`` / 0 in their unused coordinates. Offsets (Double on disk)
    round to float32, as the JAX package stores them.
    """
    slot_maps, depths = [], []
    k = 1
    for records in trees:
        slots, depth = _assign_heap_slots(records)
        slot_maps.append(slots)
        depths.append(depth)
        for r in records:
            if r["leftChild"] >= 0:
                k = max(k, len(r["indices"]))
    height = max(depths) if depths else 0
    _check_depth(height)
    m = 2 ** (height + 1) - 1
    t = len(trees)
    indices = np.full((t, m, k), -1, np.int32)
    weights = np.zeros((t, m, k), np.float32)
    offset = np.zeros((t, m), np.float32)
    num_instances = np.full((t, m), -1, np.int32)
    for ti, records in enumerate(trees):
        slots = slot_maps[ti]
        for r in records:
            slot = slots[r["id"]]
            if r["leftChild"] >= 0:
                nk = len(r["indices"])
                indices[ti, slot, :nk] = r["indices"]
                weights[ti, slot, :nk] = r["weights"]
                offset[ti, slot] = r["offset"]
            else:
                num_instances[ti, slot] = r["numInstances"]
    return ExtendedForest(*(torch.from_numpy(a) for a in (indices, weights, offset, num_instances)))


def _read_metadata(path: str) -> dict:
    """First line of the metadata part file (loadMetadata,
    core/IsolationForestModelReadWriteUtils.scala:97-104)."""
    meta_dir = os.path.join(path, "metadata")
    part = os.path.join(meta_dir, "part-00000")
    if not os.path.exists(part):
        parts = sorted(f for f in os.listdir(meta_dir) if f.startswith("part-"))
        if not parts:
            raise FileNotFoundError(f"no metadata part files under {meta_dir}")
        part = os.path.join(meta_dir, parts[0])
    with open(part) as fh:
        return json.loads(fh.readline())


def _read_data(path: str) -> List[dict]:
    data_dir = os.path.join(path, "data")
    records: List[dict] = []
    for fname in sorted(os.listdir(data_dir)):
        if fname.endswith(".avro"):
            _, recs = avro.read_container(os.path.join(data_dir, fname))
            records.extend(recs)
    if not records:
        raise FileNotFoundError(f"no avro data files under {data_dir}")
    return records


def _group_trees(records: List[dict], payload_field: str) -> List[List[dict]]:
    """groupByKey(treeID) + sortByKey (IsolationForestModelReadWrite.scala:282-288)."""
    trees: dict = {}
    for rec in records:
        if payload_field not in rec:
            raise ValueError(
                f"corrupt model data: node records carry no {payload_field!r} field "
                "(the node table does not match the metadata class)"
            )
        trees.setdefault(rec["treeID"], []).append(rec[payload_field])
    tree_ids = sorted(trees)
    if tree_ids != list(range(len(tree_ids))):
        raise ValueError("corrupt model data: treeIDs are not contiguous 0..T-1")
    return [sorted(trees[t], key=lambda r: r["id"]) for t in tree_ids]


def _is_partial_dir(path: str) -> bool:
    return _TMP_MARKER in os.path.basename(os.path.normpath(path))


def _clean_stale_partials(path: str) -> None:
    """Remove the temporary directories killed writers left for ``path``."""
    parent, base = os.path.split(os.path.abspath(os.path.normpath(path)))
    if not os.path.isdir(parent):
        return
    for name in os.listdir(parent):
        if name.startswith(base + _TMP_MARKER):
            stale = os.path.join(parent, name)
            logger.warning("removing stale partial write %s (left by an interrupted save)", stale)
            shutil.rmtree(stale, ignore_errors=True)


def _begin_atomic_dir(path: str, overwrite: bool) -> str:
    """Start an atomic directory write: a new empty temporary directory
    beside ``path``, so the final rename stays on one filesystem."""
    if os.path.exists(path) and not overwrite:
        raise FileExistsError(f"path {path} already exists; pass overwrite=True to replace")
    if overwrite:
        _clean_stale_partials(path)
    tmp = f"{os.path.normpath(path)}{_TMP_MARKER}{uuid.uuid4().hex[:12]}"
    os.makedirs(tmp)
    return tmp


def _commit_atomic_dir(tmp: str, path: str, overwrite: bool) -> None:
    """Seal the temporary directory with its manifest, then rename it into place."""
    _manifest.write(tmp)
    if os.path.exists(path):
        if not overwrite:  # another writer may have landed first
            raise FileExistsError(f"path {path} already exists; pass overwrite=True to replace")
        shutil.rmtree(path)
    os.rename(tmp, path)


@contextlib.contextmanager
def _atomic_dir(path: str, overwrite: bool):
    """``with _atomic_dir(path, overwrite) as tmp:`` write into ``tmp``; it
    is committed on success and removed on any failure, so an aborted save
    leaves the target untouched and nothing behind."""
    tmp = _begin_atomic_dir(path, overwrite)
    try:
        yield tmp
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _commit_atomic_dir(tmp, path, overwrite)


def _write_metadata(path: str, metadata: dict) -> None:
    os.makedirs(os.path.join(path, "metadata"), exist_ok=True)
    with open(os.path.join(path, "metadata", "part-00000"), "w") as fh:
        fh.write(json.dumps(metadata, separators=(",", ":")))
        fh.write("\n")
    open(os.path.join(path, "metadata", "_SUCCESS"), "w").close()


def _model_metadata(model, class_name: str) -> dict:
    meta = {
        "class": class_name,
        "timestamp": int(time.time() * 1000),
        "sparkVersion": SPARK_VERSION_STRING,
        "uid": model.uid,
        "paramMap": model.params.to_param_map(),
        # extras (IsolationForestModelReadWrite.scala:220-224)
        "outlierScoreThreshold": model.outlier_score_threshold if model.outlier_score_threshold >= 0 else -1.0,
        "numSamples": model.num_samples,
        "numFeatures": model.num_features,
        "totalNumFeatures": model.total_num_features,
    }
    # tolerated extra: the preferred scoring representation, written only
    # when it is not the default (readers that do not know it lose nothing
    # but the preference; the node table is always the exact f32 form)
    representation = getattr(model, "scoring_representation", "f32")
    if representation != "f32":
        meta["scoringRepresentation"] = representation
    return meta


def _save_model(model, path: str, overwrite: bool, metadata: dict, schema: dict, payload: str, trees) -> None:
    """Write a model directory atomically: the metadata, the baseline
    sidecar, then one Avro part of ``(treeID, payload)`` rows, one per node
    record of ``trees``."""
    with _atomic_dir(path, overwrite) as tmp:
        _write_metadata(tmp, metadata)
        _write_baseline(model, tmp)
        records = [{"treeID": t, payload: node} for t, nodes in enumerate(trees) for node in nodes]
        os.makedirs(os.path.join(tmp, "data"))
        avro.write_container(os.path.join(tmp, "data", f"part-00000-{uuid.uuid4()}-c000.avro"), schema, records)
        open(os.path.join(tmp, "data", "_SUCCESS"), "w").close()


def save_standard_model(model, path: str, overwrite: bool = False) -> None:
    """Save a standard model atomically in the reference's layout. The
    forest is copied to the host once and encoded there."""
    feature, threshold, num_instances = (a.cpu().numpy() for a in model.forest)
    trees = (standard_tree_to_records(feature[t], threshold[t], num_instances[t]) for t in range(feature.shape[0]))
    _save_model(model, path, overwrite, _model_metadata(model, STANDARD_MODEL_CLASS), STANDARD_SCHEMA, "nodeData",
                trees)
    logger.info("saved IsolationForestModel (%d trees) to %s", feature.shape[0], path)


def save_extended_model(model, path: str, overwrite: bool = False) -> None:
    """Save an extended model atomically in the reference's layout. The
    paramMap always carries the resolved ``extensionLevel``, even when the
    estimator left it unset (ExtendedIsolationForest.scala:102)."""
    indices, weights, offset, num_instances = (a.cpu().numpy() for a in model.forest)
    metadata = _model_metadata(model, EXTENDED_MODEL_CLASS)
    metadata["paramMap"]["extensionLevel"] = int(model.extension_level)
    trees = (extended_tree_to_records(indices[t], weights[t], offset[t], num_instances[t])
             for t in range(indices.shape[0]))
    _save_model(model, path, overwrite, metadata, EXTENDED_SCHEMA, "extendedNodeData", trees)
    logger.info("saved ExtendedIsolationForestModel (%d trees) to %s", indices.shape[0], path)


def save_estimator(estimator, path: str, class_name: str, overwrite: bool = False) -> None:
    """Save an estimator's params (metadata only, IsolationForest.scala:114-125)."""
    with _atomic_dir(path, overwrite) as tmp:
        _write_metadata(tmp, {
            "class": class_name,
            "timestamp": int(time.time() * 1000),
            "sparkVersion": SPARK_VERSION_STRING,
            "uid": estimator.uid,
            "paramMap": estimator.params.to_param_map(),
        })


def load_estimator(path: str, params_cls, expected_class: str, require_success: bool = True):
    """Load an estimator's ``(params, uid)``."""
    _check_model_dir(path, require_success, expect_data=False)
    _verify_manifest(path, "auto")
    metadata = _read_metadata(path)
    _check_class(metadata, expected_class)
    return params_cls.from_param_map(metadata["paramMap"]), metadata.get("uid")


def _check_model_dir(path: str, require_success: bool, expect_data: bool = True) -> None:
    """Refuse partial writes and unsealed directories before reading a byte."""
    if not os.path.isdir(path):
        raise FileNotFoundError(f"no model directory at {path}")
    if _is_partial_dir(path):
        raise ValueError(
            f"{path} is a partial write left by an interrupted save (temp "
            f"marker {_TMP_MARKER!r} in its name): the writer died before "
            "the atomic rename, so its contents are not trustworthy. Delete "
            "it and re-save; a save(..., overwrite=True) to the real path "
            "cleans such leftovers automatically"
        )
    if require_success:
        wanted = ["metadata/_SUCCESS"] + (["data/_SUCCESS"] if expect_data else [])
        missing = [m for m in wanted if not os.path.exists(os.path.join(path, *m.split("/")))]
        if missing:
            raise ValueError(
                f"{path} is not a sealed model directory (missing "
                f"{', '.join(missing)}): the writer never finished. Pass "
                "require_success=False to load it anyway"
            )


def _verify_manifest(path: str, verify, on_corrupt: str = "raise") -> List[str]:
    """The manifest gate of a load. ``verify``: ``"auto"`` verifies a
    present manifest and warns when there is none (the reference's and
    Spark's layouts), ``True`` requires one, ``False`` skips the check.
    Returns the data-file issues an ``on_corrupt="drop"`` load may
    tolerate; any other mismatch raises."""
    if verify is False:
        return []
    if verify not in ("auto", True):
        raise ValueError(f"verify must be 'auto', True or False, got {verify!r}")
    if not _manifest.present(path):
        if verify is True:
            raise ValueError(
                f"{path} has no {_manifest.MANIFEST_NAME} but verify=True was "
                "requested; pass verify='auto' to accept legacy/Spark-written layouts"
            )
        logger.warning(
            "model directory %s has no %s (legacy/Spark-written layout); "
            "integrity verification skipped", path, _manifest.MANIFEST_NAME,
        )
        return []
    issues = _manifest.verify(path)
    if not issues:
        return []
    data_issues = [i for i in issues if i.startswith("data/")]
    if len(data_issues) < len(issues) or on_corrupt != "drop":
        raise ValueError(
            f"model directory {path} failed manifest verification: " + "; ".join(issues)
            + ". The directory is corrupt; restore it from source, or pass "
            "on_corrupt='drop' to salvage the intact trees (data files only)"
        )
    return data_issues


def _read_data_tolerant(path: str) -> Tuple[List[dict], List[str]]:
    """Best-effort record read of a degraded load, with errors contained
    per file, block and record: ``(records, issues)``."""
    data_dir = os.path.join(path, "data")
    records: List[dict] = []
    issues: List[str] = []
    fnames = sorted(f for f in os.listdir(data_dir) if f.endswith(".avro")) if os.path.isdir(data_dir) else []
    if not fnames:
        return records, ["data/: no avro part files"]
    for fname in fnames:
        try:
            schema, blocks, file_issues = avro.read_blocks_tolerant(os.path.join(data_dir, fname))
        except Exception as exc:
            issues.append(f"{fname}: unreadable container ({exc})")
            continue
        issues.extend(file_issues)
        for bi, (count, body) in enumerate(blocks):
            # a record takes at least 2 bytes, so a larger count is
            # corruption; bounding it keeps a flipped varint from driving
            # a huge decode loop
            if count <= 0 or count > len(body):
                issues.append(f"{fname} block {bi}: implausible record count {count}")
                continue
            reader = avro._Reader(body)
            block_records: List[dict] = []
            try:
                for _ in range(count):
                    block_records.append(avro.decode_value(schema, reader))
                if reader.pos != len(body):
                    raise ValueError(f"{len(body) - reader.pos} undecoded trailing bytes")
            except Exception as exc:
                issues.append(f"{fname} block {bi}: corrupt records ({exc})")
                continue
            records.extend(block_records)
    return records, issues


_I32_MIN, _I32_MAX = -(2**31), 2**31 - 1


def _tree_records_sane(records: List[dict], kind: str, max_k) -> None:
    """Value checks of one salvaged tree: every field must fit the forest
    tensors (int32 ids and counts, finite floats, a bounded hyperplane
    width); a tree that parses can still carry poisoned values."""
    for r in records:
        for field in ("id", "leftChild", "rightChild"):
            v = r[field]
            if not isinstance(v, int) or not _I32_MIN <= v <= _I32_MAX:
                raise ValueError(f"{field}={v!r} out of range")
        if not _I32_MIN <= r["numInstances"] <= _I32_MAX:
            raise ValueError(f"numInstances={r['numInstances']!r} out of range")
        internal = r["leftChild"] >= 0
        if kind == "standard":
            if internal and not np.isfinite(r["splitValue"]):
                raise ValueError(f"non-finite splitValue {r['splitValue']!r}")
            if internal and not 0 <= r["splitAttribute"] <= _I32_MAX:
                raise ValueError(f"splitAttribute={r['splitAttribute']!r} invalid")
        else:
            if not np.isfinite(r["offset"]):
                raise ValueError(f"non-finite offset {r['offset']!r}")
            idx, w = r["indices"], r["weights"]
            if len(idx) != len(w):
                raise ValueError("indices/weights length mismatch")
            if max_k is not None and len(idx) > max_k:
                raise ValueError(f"hyperplane width {len(idx)} exceeds the model's feature count {max_k}")
            if internal and (any(not 0 <= i <= _I32_MAX for i in idx) or any(not np.isfinite(v) for v in w)):
                raise ValueError("corrupt hyperplane coordinates")


def _salvage_trees(records: List[dict], payload_field: str, kind: str, expected, max_k):
    """Group records by treeID and keep the trees that validate fully
    (contiguous pre-order ids, bounded depth, sane values):
    ``({tree id: sorted records}, issues)``."""
    trees: dict = {}
    malformed = 0
    for rec in records:
        try:
            tid = rec["treeID"]
            payload = rec[payload_field]
            if payload is None:
                raise ValueError("null node payload")
            if not isinstance(tid, int) or tid < 0 or tid > _I32_MAX:
                raise ValueError(f"bad treeID {tid!r}")
            if expected is not None and tid >= expected:
                raise ValueError(f"phantom treeID {tid} >= numEstimators")
            trees.setdefault(tid, []).append(payload)
        except Exception:
            malformed += 1
    issues = [f"{malformed} malformed node records discarded"] if malformed else []
    good: dict = {}
    for tid in sorted(trees):
        recs = sorted(trees[tid], key=lambda r: r.get("id", -1))
        try:
            _tree_records_sane(recs, kind, max_k)
            _assign_heap_slots(recs)
        except Exception as exc:
            # repr: a KeyError from a dangling child pointer prints as the bare key
            issues.append(f"tree {tid}: {exc!r}")
            continue
        good[tid] = recs
    return good, issues


def _load_forest_tolerant(path: str, payload_field: str, kind: str, to_forest, expected, max_k, pre_issues):
    """The ``on_corrupt="drop"`` read: salvage the intact trees into a
    smaller CPU forest and report what was lost, ``(forest, LoadReport)``.
    Scores of the smaller forest divide by its own tree count."""
    records, issues = _read_data_tolerant(path)
    issues = list(pre_issues) + issues
    good, tree_issues = _salvage_trees(records, payload_field, kind, expected, max_k)
    issues += tree_issues
    kept_ids = sorted(good)
    if not kept_ids:
        raise ValueError(f"no usable tree data under {path} even with on_corrupt='drop': " + "; ".join(issues[:10]))
    dropped = tuple(sorted(set(range(expected)) - set(kept_ids))) if expected is not None else ()
    forest = to_forest([good[t] for t in kept_ids])
    if dropped or issues:
        degrade(
            "dropped_trees",
            f"{expected if expected is not None else '?'}-tree forest",
            f"{len(kept_ids)}-tree forest",
            detail=(
                f"loaded {path} in degraded mode: kept {len(kept_ids)} trees"
                + (f", dropped tree ids {list(dropped)}" if dropped else "")
                + (f"; issues: {'; '.join(issues[:5])}" if issues else "")
                + " — scoring normalisation rescales to the surviving trees"
            ),
        )
    report = LoadReport(path=path, expected_trees=expected, kept_trees=len(kept_ids), dropped_tree_ids=dropped,
                        issues=tuple(issues))
    return forest, report


def _expected_trees(metadata: dict):
    try:
        n = int(metadata["paramMap"]["numEstimators"])
        return n if n > 0 else None
    except (KeyError, TypeError, ValueError):
        return None


def _write_baseline(model, tmp: str) -> None:
    """Write the model's drift baseline, if it has one, as the
    ``_BASELINE.json`` sidecar inside the atomic temp dir, so the manifest
    seals it with the node table."""
    from ..telemetry.monitor import BASELINE_NAME

    baseline = getattr(model, "baseline", None)
    if baseline is not None:
        baseline.save(os.path.join(tmp, BASELINE_NAME))


def _read_baseline(path: str):
    """The ``_BASELINE.json`` sidecar, or None with a warning when it is
    missing (a legacy or reference directory, or a fit without capture),
    unreadable or of an unsupported version."""
    from ..telemetry.monitor import BASELINE_NAME, Baseline

    sidecar = os.path.join(path, BASELINE_NAME)
    if not os.path.exists(sidecar):
        logger.warning(
            "model directory %s has no %s sidecar (legacy/reference layout "
            "or a fit with baseline capture disabled): drift monitoring is "
            "unavailable for this model until it is refitted", path, BASELINE_NAME,
        )
        return None
    try:
        return Baseline.load(sidecar)
    except Exception as exc:
        logger.warning(
            "ignoring unreadable baseline sidecar %s (%s): drift monitoring "
            "unavailable for this model", sidecar, exc,
        )
        return None


def _check_class(metadata: dict, expected: str) -> None:
    if metadata.get("class") != expected:
        raise ValueError(f"metadata class mismatch: expected {expected}, found {metadata.get('class')}")


_ON_CORRUPT = ("raise", "drop")


def _load_common(path: str, expected_class: str, require_success: bool, verify="auto", on_corrupt: str = "raise"):
    """Directory checks, the manifest and metadata: ``(metadata,
    total_num_features, data_issues)``."""
    if on_corrupt not in _ON_CORRUPT:
        raise ValueError(f"on_corrupt must be 'raise' or 'drop', got {on_corrupt!r}")
    _check_model_dir(path, require_success)
    data_issues = _verify_manifest(path, verify, on_corrupt)
    metadata = _read_metadata(path)
    _check_class(metadata, expected_class)
    if "totalNumFeatures" in metadata:
        return metadata, int(metadata["totalNumFeatures"]), data_issues
    # legacy layout (IsolationForestModelReadWrite.scala:298-306)
    logger.warning(
        "loading legacy model without totalNumFeatures; feature-width "
        "validation disabled (sentinel -1)"
    )
    return metadata, UNKNOWN_TOTAL_NUM_FEATURES, data_issues


def _read_forest(path: str, metadata: dict, on_corrupt: str, data_issues, payload: str, kind: str, to_forest,
                 max_k=None):
    """The node table as a CPU forest: strictly, or salvaged by
    ``on_corrupt="drop"``; ``(forest, LoadReport or None)``."""
    if on_corrupt == "drop":
        return _load_forest_tolerant(path, payload, kind, to_forest, _expected_trees(metadata), max_k, data_issues)
    return to_forest(_group_trees(_read_data(path), payload)), None


def _restore_representation(model, metadata: dict) -> None:
    """Restore the ``scoringRepresentation`` extra. Absent means ``"f32"``;
    an unknown value, or ``"q16"`` for a forest outside the plane's fences
    (one edited on disk, or salvaged smaller), logs a warning and stays
    ``"f32"``: the representation is a preference, never an input to the
    scores."""
    representation = metadata.get("scoringRepresentation", "f32")
    if representation == "f32":
        return
    try:
        model.set_scoring_representation(representation)
    except ValueError as exc:
        logger.warning("ignoring persisted scoringRepresentation=%r: %s", representation, exc)


def _finish_load(model, path: str, metadata: dict, load_report):
    """The load report, the baseline sidecar, the scoring representation
    and the threshold."""
    model.load_report = load_report
    model.baseline = _read_baseline(path)
    _restore_representation(model, metadata)
    threshold = float(metadata.get("outlierScoreThreshold", -1.0))
    if threshold >= 0:
        model.set_outlier_score_threshold(threshold)
    return model


def load_standard_model(path: str, device=None, require_success: bool = True, verify="auto",
                        on_corrupt: str = "raise"):
    """Load a standard model directory onto ``device`` (default: the card).
    ``verify``: the manifest check (:func:`_verify_manifest`);
    ``on_corrupt``: ``"raise"``, or ``"drop"`` to salvage the intact trees."""
    from ..models.isolation_forest import IsolationForestModel

    dev = resolve_device(device)
    metadata, total_num_features, data_issues = _load_common(path, STANDARD_MODEL_CLASS, require_success, verify,
                                                             on_corrupt)
    forest, report = _read_forest(path, metadata, on_corrupt, data_issues, "nodeData", "standard",
                                  records_to_standard_forest)
    model = IsolationForestModel(
        forest=forest.to(dev),
        params=IsolationForestParams.from_param_map(metadata["paramMap"]),
        num_samples=int(metadata["numSamples"]),
        num_features=int(metadata["numFeatures"]),
        total_num_features=total_num_features,
        uid=metadata.get("uid"),
    )
    return _finish_load(model, path, metadata, report)


def load_extended_model(path: str, device=None, require_success: bool = True, verify="auto",
                        on_corrupt: str = "raise"):
    """Load an extended model directory onto ``device`` (default: the card).
    A model whose paramMap has no ``extensionLevel`` records ``k - 1``.
    ``verify`` and ``on_corrupt`` as :func:`load_standard_model`; a
    salvaged hyperplane may be at most ``numFeatures`` wide."""
    from ..models.extended import ExtendedIsolationForestModel

    dev = resolve_device(device)
    metadata, total_num_features, data_issues = _load_common(path, EXTENDED_MODEL_CLASS, require_success, verify,
                                                             on_corrupt)
    params = ExtendedIsolationForestParams.from_param_map(metadata["paramMap"])
    forest, report = _read_forest(path, metadata, on_corrupt, data_issues, "extendedNodeData", "extended",
                                  records_to_extended_forest, int(metadata.get("numFeatures", 0)) or None)
    model = ExtendedIsolationForestModel(
        forest=forest.to(dev),
        params=params,
        num_samples=int(metadata["numSamples"]),
        num_features=int(metadata["numFeatures"]),
        extension_level=params.extension_level if params.extension_level is not None else forest.k - 1,
        total_num_features=total_num_features,
        uid=metadata.get("uid"),
    )
    return _finish_load(model, path, metadata, report)


def load_model(path: str, device=None, require_success: bool = True, verify="auto", on_corrupt: str = "raise"):
    """Load a model directory as the class its metadata names: an
    :class:`ExtendedIsolationForestModel` for the extended class, else an
    :class:`IsolationForestModel` (which refuses any other class)."""
    _check_model_dir(path, require_success)
    load = load_extended_model if _read_metadata(path).get("class") == EXTENDED_MODEL_CLASS else load_standard_model
    return load(path, device=device, require_success=require_success, verify=verify, on_corrupt=on_corrupt)
