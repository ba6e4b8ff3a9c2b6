"""ONNX export of standard isolation-forest models.

Capability parity with the reference's Python converter module
(``isolation-forest-onnx/src/isolationforestonnx/isolation_forest_converter.py``):
the persisted model (metadata JSON + Avro node table) becomes an ONNX graph

    features --ai.onnx.ml.TreeEnsembleRegressor--> expected path length E[h]
             --Div(c(n))--Neg--Pow(2,.)--> outlierScore
             --Less(threshold)--Not--Cast--> predictedLabel (int32)

mirroring the reference graph topology (converter :177-341): the regressor
aggregates with ``AVERAGE``, branch mode ``BRANCH_LT`` so the *true* branch is
``x < splitValue`` = left child, and each leaf's target weight is
``depth + avg_path_length(numInstances)`` with depth recomputed from the
pre-order parent map (:361-373). ``IsolationForestConverter`` keeps the
reference's standard-only restriction; ``ExtendedIsolationForestConverter``
goes beyond the reference and exports hyperplane forests too, by lifting each
node test into a virtual dot-product feature (see its docstring).

Opsets: ``ai.onnx.ml`` v1 + core v14, ``ir_version`` 10 (:156-166).
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

from ..io.persistence import (
    EXTENDED_MODEL_CLASS,
    STANDARD_MODEL_CLASS,
    _group_trees,
    _read_data,
    _read_metadata,
)
from . import proto

_EULER = 0.5772156649


def _avg_path_len(n: int) -> float:
    """float64 normaliser, like the reference converter's _get_avg_path_len
    (:343-360); cast to f32 at attribute-encode time. It stays in ``math``,
    not ``utils.math``'s float32 ``c(n)``, so the bytes are the JAX
    package's converter's bit for bit."""
    if n <= 1:
        return 0.0
    return 2.0 * (math.log(n - 1.0) + _EULER) - 2.0 * (n - 1.0) / n


def _node_depths(records: List[dict]) -> Dict[int, int]:
    """Depth per node id from the pre-order parent map (converter :361-373)."""
    depths = {0: 0}
    for r in records:
        if r["leftChild"] >= 0:
            depths[r["leftChild"]] = depths[r["id"]] + 1
            depths[r["rightChild"]] = depths[r["id"]] + 1
    return depths

def _build_ensemble_attrs(trees: List[List[dict]], split_of) -> List[bytes]:
    """Shared TreeEnsembleRegressor attribute builder. ``split_of(tree_id,
    record) -> (featureid, value)`` abstracts the one thing that differs
    between the standard converter (splitAttribute/splitValue) and the
    extended one (lifted column / offset)."""
    treeids, nodeids, featureids, modes = [], [], [], []
    values, true_ids, false_ids, missing = [], [], [], []
    t_treeids, t_nodeids, t_ids, t_weights = [], [], [], []
    for tree_id, records in enumerate(trees):
        depths = _node_depths(records)
        for r in records:
            treeids.append(tree_id)
            nodeids.append(r["id"])
            missing.append(0)
            if r["leftChild"] >= 0:
                fid, value = split_of(tree_id, r)
                featureids.append(fid)
                modes.append("BRANCH_LT")  # true branch: x < value -> left
                values.append(float(value))
                true_ids.append(r["leftChild"])
                false_ids.append(r["rightChild"])
            else:
                featureids.append(0)
                modes.append("LEAF")
                values.append(0.0)
                true_ids.append(0)
                false_ids.append(0)
                t_treeids.append(tree_id)
                t_nodeids.append(r["id"])
                t_ids.append(0)
                t_weights.append(
                    depths[r["id"]] + _avg_path_len(int(r["numInstances"]))
                )
    return [
        proto.attribute("aggregate_function", "AVERAGE"),
        proto.attribute("n_targets", 1),
        proto.attribute("nodes_falsenodeids", false_ids),
        proto.attribute("nodes_featureids", featureids),
        proto.attribute("nodes_hitrates", [1.0] * len(nodeids)),
        proto.attribute("nodes_missing_value_tracks_true", missing),
        proto.attribute("nodes_modes", modes),
        proto.attribute("nodes_nodeids", nodeids),
        proto.attribute("nodes_treeids", treeids),
        proto.attribute("nodes_truenodeids", true_ids),
        proto.attribute("nodes_values", values),
        proto.attribute("post_transform", "NONE"),
        proto.attribute("target_ids", t_ids),
        proto.attribute("target_nodeids", t_nodeids),
        proto.attribute("target_treeids", t_treeids),
        proto.attribute("target_weights", t_weights),
    ]


def _build_score_model(
    graph_name: str,
    num_features: int,
    num_samples: int,
    threshold: float,
    ensemble_attrs: List[bytes],
    ensemble_input: str = "features",
    prefix_nodes: List[bytes] = (),
    extra_initializers: List[bytes] = (),
) -> bytes:
    """Shared score-chain graph: TreeEnsembleRegressor -> Div(c(n)) -> Neg ->
    Pow(2,.) -> Less/Not/Cast, with optional prefix nodes (e.g. the extended
    converter's lifting MatMul). ``threshold <= 0`` (unset) uses a sentinel
    above the score range so every label is 0, matching
    IsolationForestModel.transform (:142-148)."""
    c_n = float(np.float32(_avg_path_len(num_samples)))
    thr = threshold if threshold > 0 else 2.0
    nodes = list(prefix_nodes) + [
        proto.node(
            "TreeEnsembleRegressor",
            [ensemble_input],
            ["expectedPathLength"],
            name="treeEnsemble",
            domain="ai.onnx.ml",
            attributes=ensemble_attrs,
        ),
        proto.node("Div", ["expectedPathLength", "cN"], ["normalizedPathLength"]),
        proto.node("Neg", ["normalizedPathLength"], ["negatedPathLength"]),
        proto.node("Pow", ["two", "negatedPathLength"], ["outlierScore"]),
        proto.node("Less", ["outlierScore", "scoreThreshold"], ["isInlier"]),
        proto.node("Not", ["isInlier"], ["isOutlier"]),
        proto.node(
            "Cast",
            ["isOutlier"],
            ["predictedLabel"],
            attributes=[proto.attribute("to", proto.INT32)],
        ),
    ]
    graph = proto.graph(
        nodes,
        name=graph_name,
        inputs=[proto.value_info("features", proto.FLOAT, ["batch", num_features])],
        outputs=[
            proto.value_info("outlierScore", proto.FLOAT, ["batch", 1]),
            proto.value_info("predictedLabel", proto.INT32, ["batch", 1]),
        ],
        initializers=list(extra_initializers)
        + [
            proto.tensor_f32("cN", [c_n]),
            proto.tensor_f32("two", [2.0]),
            proto.tensor_f32("scoreThreshold", [thr]),
        ],
    )
    model_bytes = proto.model(graph, opset_imports=[("ai.onnx.ml", 1), ("", 14)])
    # independent structural gate, the analogue of the reference's
    # checker.check_model call (isolation_forest_converter.py:168-173): the
    # checker re-parses the bytes with its own wire tables, so a writer
    # field-number slip fails loudly here instead of round-tripping silently
    from .checker import check_model

    check_model(model_bytes)
    return model_bytes


class IsolationForestConverter:
    """Convert a persisted standard model directory to ONNX bytes.

    Accepts the reference's on-disk layout (so it can convert models written
    by the Spark implementation too) — the same coupling surface as the
    reference's converter, which reads metadata JSON + Avro node rows.
    """

    def __init__(self, model_path: str):
        metadata = _read_metadata(model_path)
        if metadata.get("class") != STANDARD_MODEL_CLASS:
            raise ValueError(
                "ONNX conversion supports the standard IsolationForestModel only "
                f"(got class {metadata.get('class')!r}) — hyperplane splits of the "
                "extended model cannot be expressed as an ONNX tree ensemble"
            )
        self._metadata = metadata
        self._trees = _group_trees(_read_data(model_path), "nodeData")
        self.num_features = int(metadata["numFeatures"])
        self.num_samples = int(metadata["numSamples"])
        self.threshold = float(metadata.get("outlierScoreThreshold", -1.0))
        # serving-representation extra (the q16 plane):
        # surfaced for operators; the export itself always encodes the exact
        # f32 thresholds — the q16 plane is decision-identical to them by
        # construction, so portable inference is faithful for either
        # preference without a quantized ONNX variant
        self.scoring_representation = metadata.get("scoringRepresentation", "f32")

    def convert(self) -> bytes:
        """Build the serialized ModelProto."""
        attrs = _build_ensemble_attrs(
            self._trees, lambda t, r: (r["splitAttribute"], r["splitValue"])
        )
        return _build_score_model(
            "isolationForest",
            self.num_features,
            self.num_samples,
            self.threshold,
            attrs,
        )

    def convert_and_save(self, output_path: str) -> None:
        with open(output_path, "wb") as fh:
            fh.write(self.convert())


class ExtendedIsolationForestConverter:
    """ONNX export for the *extended* forest — beyond the reference, which
    cannot express hyperplane splits in ``TreeEnsembleRegressor``.

    The lifting trick: a node's test ``dot(x, w_n) < offset_n`` is an
    axis-aligned comparison on the virtual feature ``z_n = dot(x, w_n)``.
    Assign every internal node a column of a lifted feature space, prepend one
    ``MatMul(features, W)`` (a dense projection), and the
    extended forest becomes a perfectly standard tree ensemble over ``z`` —
    same downstream Div/Neg/Pow/Less/Not/Cast chain as the standard converter.
    """

    def __init__(self, model_path: str):
        metadata = _read_metadata(model_path)
        if metadata.get("class") != EXTENDED_MODEL_CLASS:
            raise ValueError(
                f"expected an ExtendedIsolationForestModel directory, got class "
                f"{metadata.get('class')!r}"
            )
        self._metadata = metadata
        self._trees = _group_trees(_read_data(model_path), "extendedNodeData")
        self.num_features = int(metadata["numFeatures"])
        self.num_samples = int(metadata["numSamples"])
        self.threshold = float(metadata.get("outlierScoreThreshold", -1.0))
        # same representation carry as the standard converter: recorded, and
        # the export stays the exact f32 form q16 is decision-identical to
        self.scoring_representation = metadata.get("scoringRepresentation", "f32")

    def _lift(self):
        """Assign lifted columns; returns (W [F, n_cols], per-node column map)."""
        cols: List[np.ndarray] = []
        col_of: List[Dict[int, int]] = []
        offsets: List[Dict[int, float]] = []
        for records in self._trees:
            mapping: Dict[int, int] = {}
            offs: Dict[int, float] = {}
            for r in records:
                if r["leftChild"] >= 0:
                    w = np.zeros(self.num_features, np.float32)
                    w[np.asarray(r["indices"], np.int64)] = np.asarray(
                        r["weights"], np.float32
                    )
                    mapping[r["id"]] = len(cols)
                    offs[r["id"]] = float(r["offset"])
                    cols.append(w)
            col_of.append(mapping)
            offsets.append(offs)
        W = (
            np.stack(cols, axis=1)
            if cols
            else np.zeros((self.num_features, 1), np.float32)
        )
        return W, col_of, offsets

    def convert(self) -> bytes:
        W, col_of, offsets = self._lift()
        attrs = _build_ensemble_attrs(
            self._trees,
            lambda t, r: (col_of[t][r["id"]], offsets[t][r["id"]]),
        )
        return _build_score_model(
            "extendedIsolationForest",
            self.num_features,
            self.num_samples,
            self.threshold,
            attrs,
            ensemble_input="lifted",
            prefix_nodes=[
                proto.node("MatMul", ["features", "liftedWeights"], ["lifted"])
            ],
            extra_initializers=[proto.tensor_f32("liftedWeights", W)],
        )

    def convert_and_save(self, output_path: str) -> None:
        with open(output_path, "wb") as fh:
            fh.write(self.convert())


def convert_and_save(model_path: str, output_path: str) -> None:
    """Auto-detecting converter entry point: standard or extended model dir."""
    metadata = _read_metadata(model_path)
    if metadata.get("class") == EXTENDED_MODEL_CLASS:
        ExtendedIsolationForestConverter(model_path).convert_and_save(output_path)
    else:
        IsolationForestConverter(model_path).convert_and_save(output_path)
