"""Save and load models in the reference's on-disk layout
(``isoforest_tpu/io/persistence.py``).

A model directory holds ``metadata/part-00000`` (one JSON line: class,
uid, paramMap, outlierScoreThreshold, numSamples, numFeatures,
totalNumFeatures) and ``data/*.avro``, one row per node, ``(treeID,
nodeData)`` or ``(treeID, extendedNodeData)`` with pre-order ids and ``-1``
sentinels (IsolationForestModelReadWrite.scala:82-132). The heap-tensor
forest is written in pre-order and rebuilt on load, so each package loads
what the other saves.

A save builds the whole directory under a sibling temporary name
(``<path>.__tmp-<hex>``), seals it with ``_MANIFEST.json``
(:mod:`..resilience.manifest`) and renames it into place, so no reader sees
a partial model; a load refuses such a temporary directory and verifies a
present manifest before it reads a byte of Avro. Not ported yet:
``on_corrupt="drop"`` and the drift-baseline sidecar.
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
    return {
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


def _save_model(path: str, overwrite: bool, metadata: dict, schema: dict, payload: str, trees) -> None:
    """Write a model directory atomically: the metadata, then one Avro
    part of ``(treeID, payload)`` rows, one per node record of ``trees``."""
    with _atomic_dir(path, overwrite) as tmp:
        _write_metadata(tmp, metadata)
        records = [{"treeID": t, payload: node} for t, nodes in enumerate(trees) for node in nodes]
        os.makedirs(os.path.join(tmp, "data"))
        avro.write_container(os.path.join(tmp, "data", f"part-00000-{uuid.uuid4()}-c000.avro"), schema, records)
        open(os.path.join(tmp, "data", "_SUCCESS"), "w").close()


def save_standard_model(model, path: str, overwrite: bool = False) -> None:
    """Save a standard model atomically in the reference's layout. The
    forest is copied to the host once and encoded there."""
    feature, threshold, num_instances = (a.cpu().numpy() for a in model.forest)
    trees = (standard_tree_to_records(feature[t], threshold[t], num_instances[t]) for t in range(feature.shape[0]))
    _save_model(path, overwrite, _model_metadata(model, STANDARD_MODEL_CLASS), STANDARD_SCHEMA, "nodeData", trees)
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
    _save_model(path, overwrite, metadata, EXTENDED_SCHEMA, "extendedNodeData", trees)
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


def _verify_manifest(path: str, verify) -> None:
    """The manifest gate of a load. ``verify``: ``"auto"`` verifies a
    present manifest and warns when there is none (the reference's and
    Spark's layouts), ``True`` requires one, ``False`` skips the check. Any
    mismatch raises."""
    if verify is False:
        return
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
        return
    issues = _manifest.verify(path)
    if issues:
        raise ValueError(
            f"model directory {path} failed manifest verification: " + "; ".join(issues)
            + ". The directory is corrupt; restore it from source"
        )


def _check_class(metadata: dict, expected: str) -> None:
    if metadata.get("class") != expected:
        raise ValueError(f"metadata class mismatch: expected {expected}, found {metadata.get('class')}")


def _load_common(path: str, expected_class: str, require_success: bool, verify="auto"):
    """Directory checks, the manifest and metadata: ``(metadata,
    total_num_features)``."""
    _check_model_dir(path, require_success)
    _verify_manifest(path, verify)
    metadata = _read_metadata(path)
    _check_class(metadata, expected_class)
    if "totalNumFeatures" in metadata:
        return metadata, int(metadata["totalNumFeatures"])
    # legacy layout (IsolationForestModelReadWrite.scala:298-306)
    logger.warning(
        "loading legacy model without totalNumFeatures; feature-width "
        "validation disabled (sentinel -1)"
    )
    return metadata, UNKNOWN_TOTAL_NUM_FEATURES


def _restore_threshold(model, metadata: dict):
    threshold = float(metadata.get("outlierScoreThreshold", -1.0))
    if threshold >= 0:
        model.set_outlier_score_threshold(threshold)
    return model


def load_standard_model(path: str, device=None, require_success: bool = True, verify="auto"):
    """Load a standard model directory onto ``device`` (default: the card).
    ``verify``: the manifest check (:func:`_verify_manifest`)."""
    from ..models.isolation_forest import IsolationForestModel

    dev = resolve_device(device)
    metadata, total_num_features = _load_common(path, STANDARD_MODEL_CLASS, require_success, verify)
    forest = records_to_standard_forest(_group_trees(_read_data(path), "nodeData"))
    model = IsolationForestModel(
        forest=forest.to(dev),
        params=IsolationForestParams.from_param_map(metadata["paramMap"]),
        num_samples=int(metadata["numSamples"]),
        num_features=int(metadata["numFeatures"]),
        total_num_features=total_num_features,
        uid=metadata.get("uid"),
    )
    return _restore_threshold(model, metadata)


def load_extended_model(path: str, device=None, require_success: bool = True, verify="auto"):
    """Load an extended model directory onto ``device`` (default: the card).
    A model whose paramMap has no ``extensionLevel`` records ``k - 1``.
    ``verify``: the manifest check (:func:`_verify_manifest`)."""
    from ..models.extended import ExtendedIsolationForestModel

    dev = resolve_device(device)
    metadata, total_num_features = _load_common(path, EXTENDED_MODEL_CLASS, require_success, verify)
    params = ExtendedIsolationForestParams.from_param_map(metadata["paramMap"])
    forest = records_to_extended_forest(_group_trees(_read_data(path), "extendedNodeData"))
    model = ExtendedIsolationForestModel(
        forest=forest.to(dev),
        params=params,
        num_samples=int(metadata["numSamples"]),
        num_features=int(metadata["numFeatures"]),
        extension_level=params.extension_level if params.extension_level is not None else forest.k - 1,
        total_num_features=total_num_features,
        uid=metadata.get("uid"),
    )
    return _restore_threshold(model, metadata)


def load_model(path: str, device=None, require_success: bool = True, verify="auto"):
    """Load a model directory as the class its metadata names: an
    :class:`ExtendedIsolationForestModel` for the extended class, else an
    :class:`IsolationForestModel` (which refuses any other class)."""
    _check_model_dir(path, require_success)
    load = load_extended_model if _read_metadata(path).get("class") == EXTENDED_MODEL_CLASS else load_standard_model
    return load(path, device=device, require_success=require_success, verify=verify)
