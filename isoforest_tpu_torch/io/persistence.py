"""Load a standard or extended model saved in the reference's on-disk layout.

The load path of ``isoforest_tpu/io/persistence.py`` (``load_standard_model``
:1193, ``load_extended_model`` :1249, ``load_model`` :482): a model
directory holds ``metadata/part-00000`` (one JSON line: class, uid,
paramMap, outlierScoreThreshold, numSamples, numFeatures, totalNumFeatures)
and ``data/*.avro``, one row per node, ``(treeID, nodeData)`` or ``(treeID,
extendedNodeData)`` with pre-order ids and ``-1`` sentinels
(IsolationForestModelReadWrite.scala:82-132). The pre-order node table is
rebuilt into the heap-tensor forest. Not ported yet: manifest verification,
``on_corrupt="drop"`` and the drift-baseline sidecar.
"""

from __future__ import annotations

import json
import os
from typing import List, Tuple

import numpy as np
import torch

from ..ops.ext_growth import ExtendedForest
from ..ops.tree_growth import StandardForest
from ..utils.device import resolve_device
from ..utils.params import ExtendedIsolationForestParams, IsolationForestParams
from ..utils.validation import UNKNOWN_TOTAL_NUM_FEATURES, logger
from . import avro

STANDARD_MODEL_CLASS = "com.linkedin.relevance.isolationforest.IsolationForestModel"
EXTENDED_MODEL_CLASS = "com.linkedin.relevance.isolationforest.extended.ExtendedIsolationForestModel"

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


def _check_model_dir(path: str, require_success: bool) -> None:
    if not os.path.isdir(path):
        raise FileNotFoundError(f"no model directory at {path}")
    if require_success:
        missing = [
            m for m in ("metadata/_SUCCESS", "data/_SUCCESS")
            if not os.path.exists(os.path.join(path, *m.split("/")))
        ]
        if missing:
            raise ValueError(
                f"{path} is not a sealed model directory (missing "
                f"{', '.join(missing)}): the writer never finished. Pass "
                "require_success=False to load it anyway"
            )


def _load_common(path: str, expected_class: str, require_success: bool):
    """Directory checks and metadata: ``(metadata, total_num_features)``."""
    _check_model_dir(path, require_success)
    metadata = _read_metadata(path)
    if metadata.get("class") != expected_class:
        raise ValueError(
            f"metadata class mismatch: expected {expected_class}, "
            f"found {metadata.get('class')}"
        )
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


def load_standard_model(path: str, device=None, require_success: bool = True):
    """Load a standard model directory onto ``device`` (default: the card)."""
    from ..models.isolation_forest import IsolationForestModel

    dev = resolve_device(device)
    metadata, total_num_features = _load_common(path, STANDARD_MODEL_CLASS, require_success)
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


def load_extended_model(path: str, device=None, require_success: bool = True):
    """Load an extended model directory onto ``device`` (default: the card).
    A model whose paramMap has no ``extensionLevel`` records ``k - 1``."""
    from ..models.extended import ExtendedIsolationForestModel

    dev = resolve_device(device)
    metadata, total_num_features = _load_common(path, EXTENDED_MODEL_CLASS, require_success)
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


def load_model(path: str, device=None, require_success: bool = True):
    """Load a model directory as the class its metadata names: an
    :class:`ExtendedIsolationForestModel` for the extended class, else an
    :class:`IsolationForestModel` (which refuses any other class)."""
    _check_model_dir(path, require_success)
    if _read_metadata(path).get("class") == EXTENDED_MODEL_CLASS:
        return load_extended_model(path, device=device, require_success=require_success)
    return load_standard_model(path, device=device, require_success=require_success)
