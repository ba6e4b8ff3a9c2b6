"""The port's ONNX export (``isoforest_tpu_torch.onnx``) on the CPU.

Mirrors ``tests/test_onnx.py`` and ``tests/test_onnx_checker.py`` case for
case on the port: models fit and scored by the port (``device="cpu"``, the
kernels' plain versions), converted by the port's converter, run by the
port's numpy runtime and checked by the port's independent checker. The
cases that need the reference's checkout or onnxruntime skip as the JAX
ones do.

Across the packages: the port's converter writes the JAX converter's bytes
for the same saved directory (both committed fixtures and a port-written
save), each package's ``check_model`` accepts the other's bytes, and each
runtime (and each independent evaluator) gives the other's outputs exactly
on the same graph.

An EIF graph's lifted ``MatMul`` sums each dot in numpy's BLAS order, so it
is held to the port's gather walk (``ops.traversal.extended_path_lengths``,
XLA's order up to k = 24) within 1e-5, and to the port's own walk and dense
strategies under the JAX test's boundary bound (a flip moves a score by at
most one subtree's share, and the top 2% keep their ranks).
"""

import os
import pathlib

import numpy as np
import pytest
import torch
from conftest import _REFERENCE_RESOURCES

from isoforest_tpu_torch import (
    ExtendedIsolationForest,
    ExtendedIsolationForestModel,
    IsolationForest,
    IsolationForestModel,
    load_model,
)
from isoforest_tpu_torch.onnx import (
    ExtendedIsolationForestConverter,
    IsolationForestConverter,
    convert_and_save,
    proto,
)
from isoforest_tpu_torch.onnx.checker import (
    CheckError,
    check_model,
    parse_model_independent,
    reference_scores,
)
from isoforest_tpu_torch.onnx.converter import _avg_path_len
from isoforest_tpu_torch.onnx.runtime import parse_model, run_model

_FIXTURES = _REFERENCE_RESOURCES
PORT_FIXTURES = pathlib.Path(__file__).resolve().parent / "resources" / "torch_port"


def _scores(model, X, **kw) -> np.ndarray:
    return model.score(X, **kw).numpy()


def _gather_scores(model, X) -> np.ndarray:
    """The port's gather walk: tree by tree, XLA's summation order."""
    from isoforest_tpu_torch.ops.traversal import extended_path_lengths
    from isoforest_tpu_torch.utils.math import score_from_path_length

    pl = extended_path_lengths(model.forest, torch.from_numpy(np.ascontiguousarray(X)))
    return score_from_path_length(pl, model.num_samples).numpy()


def _assert_within_boundary_bound(onnx_scores, scores):
    """The JAX test's contract for an EIF scored in another dot order."""
    diff = np.abs(onnx_scores - scores)
    assert diff.max() < 5e-3
    k = max(1, len(diff) // 50)  # top 2%
    top_onnx = set(np.argsort(onnx_scores)[-k:])
    top_port = set(np.argsort(scores)[-k:])
    assert len(top_onnx & top_port) / k >= 0.95


@pytest.fixture(scope="module")
def saved_model(tmp_path_factory):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(3000, 6)).astype(np.float32)
    X[:60] += 4.0
    model = IsolationForest(num_estimators=25, contamination=0.02, random_seed=3, device="cpu").fit(X)
    path = str(tmp_path_factory.mktemp("onnx") / "model")
    model.save(path)
    return model, X, path


class TestAvgPathLenPins:
    @pytest.mark.parametrize(
        "n,expected",
        [(0, 0.0), (1, 0.0), (2, 0.15443133), (10, 3.74888048)],
    )
    def test_pins(self, n, expected):
        assert _avg_path_len(n) == pytest.approx(expected, abs=1e-6)


class TestGraphStructure:
    def test_model_parses_and_declares_opsets(self, saved_model):
        _, _, path = saved_model
        parsed = parse_model(IsolationForestConverter(path).convert())
        assert parsed["ir_version"] == 10
        assert ("ai.onnx.ml", 1) in parsed["opsets"]
        assert ("", 14) in parsed["opsets"]
        assert parsed["inputs"] == ["features"]
        assert parsed["outputs"] == ["outlierScore", "predictedLabel"]
        ops = [n["op_type"] for n in parsed["nodes"]]
        assert ops == [
            "TreeEnsembleRegressor", "Div", "Neg", "Pow", "Less", "Not", "Cast",
        ]

    def test_tree_attrs_consistent(self, saved_model):
        model, _, path = saved_model
        parsed = parse_model(IsolationForestConverter(path).convert())
        attrs = parsed["nodes"][0]["attrs"]
        assert attrs["aggregate_function"] == "AVERAGE"
        assert attrs["post_transform"] == "NONE"
        assert attrs["n_targets"] == 1
        n_nodes = len(attrs["nodes_nodeids"])
        assert len(attrs["nodes_modes"]) == n_nodes
        assert len(attrs["nodes_values"]) == n_nodes
        assert set(attrs["nodes_modes"]) == {"BRANCH_LT", "LEAF"}
        assert int(attrs["nodes_treeids"].max()) + 1 == model.forest.num_trees
        leaves = sum(m == "LEAF" for m in attrs["nodes_modes"])
        assert len(attrs["target_weights"]) == leaves
        assert np.all(attrs["target_weights"] >= 0)

    def test_3node_forest_attrs(self, tmp_path):
        from isoforest_tpu_torch.ops.tree_growth import StandardForest
        from isoforest_tpu_torch.utils.params import IsolationForestParams

        forest = StandardForest(
            feature=torch.tensor([[1, -1, -1]], dtype=torch.int32),
            threshold=torch.tensor([[0.25, 0.0, 0.0]], dtype=torch.float32),
            num_instances=torch.tensor([[-1, 3, 7]], dtype=torch.int32),
        )
        model = IsolationForestModel(
            forest=forest,
            params=IsolationForestParams(num_estimators=1),
            num_samples=10,
            num_features=2,
            total_num_features=2,
        )
        path = str(tmp_path / "m")
        model.save(path)
        attrs = parse_model(IsolationForestConverter(path).convert())["nodes"][0]["attrs"]
        np.testing.assert_array_equal(attrs["nodes_nodeids"], [0, 1, 2])
        assert attrs["nodes_modes"] == ["BRANCH_LT", "LEAF", "LEAF"]
        np.testing.assert_array_equal(attrs["nodes_truenodeids"], [1, 0, 0])
        np.testing.assert_array_equal(attrs["nodes_falsenodeids"], [2, 0, 0])
        np.testing.assert_allclose(
            attrs["target_weights"],
            [1 + _avg_path_len(3), 1 + _avg_path_len(7)],
            rtol=1e-6,
        )


class TestScoreParity:
    def test_parity_vs_port_scorer(self, saved_model):
        """The reference integration gate: max |score diff| < 1e-5."""
        model, X, path = saved_model
        scores, labels = run_model(IsolationForestConverter(path).convert(), {"features": X})
        port_scores = _scores(model, X)
        assert np.abs(scores[:, 0] - port_scores).max() < 1e-5
        port_labels = model.predict(torch.from_numpy(port_scores)).numpy()
        disagree = labels[:, 0] != port_labels
        if disagree.any():
            assert np.all(np.abs(port_scores[disagree] - model.outlier_score_threshold) < 1e-5)

    def test_parity_vs_onnxruntime(self, saved_model):
        """The emitted bytes through the real onnx checker and onnxruntime,
        where they are installed (``ONNX_PARITY_REQUIRED=1`` turns the
        import skips into failures)."""
        if os.environ.get("ONNX_PARITY_REQUIRED"):
            import onnx
            import onnxruntime as ort
        else:
            onnx = pytest.importorskip("onnx")
            ort = pytest.importorskip("onnxruntime")
        model, X, path = saved_model
        onnx_bytes = IsolationForestConverter(path).convert()
        onnx.checker.check_model(onnx.load_from_string(onnx_bytes))
        sess = ort.InferenceSession(onnx_bytes, providers=["CPUExecutionProvider"])
        scores, labels = sess.run(None, {"features": X})
        port_scores = _scores(model, X)
        assert np.abs(scores[:, 0] - port_scores).max() < 1e-5
        own_scores, own_labels = run_model(onnx_bytes, {"features": X})
        assert np.abs(scores - own_scores).max() < 1e-6
        disagree = (labels != own_labels)[:, 0]
        if disagree.any():
            assert np.all(np.abs(port_scores[disagree] - model.outlier_score_threshold) < 1e-5)

    def test_no_threshold_means_zero_labels(self, tmp_path):
        rng = np.random.default_rng(1)
        X = rng.normal(size=(500, 4)).astype(np.float32)
        model = IsolationForest(num_estimators=5, device="cpu").fit(X)  # contamination 0
        path = str(tmp_path / "m")
        model.save(path)
        _, labels = run_model(IsolationForestConverter(path).convert(), {"features": X})
        assert np.all(labels == 0)

    def test_reference_fixture_conversion(self, mammography, auroc_fn):
        """Convert the Spark-written fixture; reference pins AUROC 0.8596."""
        path = _FIXTURES / "savedIsolationForestModel"
        if not path.exists():
            pytest.skip("reference fixture unavailable")
        onnx_bytes = IsolationForestConverter(str(path)).convert()
        X, y = mammography
        scores, _ = run_model(onnx_bytes, {"features": X})
        assert auroc_fn(scores[:, 0], y) == pytest.approx(0.8596, abs=0.02)

    def test_extended_model_rejected_by_standard_converter(self):
        path = _FIXTURES / "savedExtendedIsolationForestModel"
        if not path.exists():
            pytest.skip("reference fixture unavailable")
        with pytest.raises(ValueError, match="standard"):
            IsolationForestConverter(str(path))

    def test_committed_fixture_parity(self, mammography):
        """The JAX-written standard fixture, loaded by the port: the graph's
        scores within 1e-5 of the port's walk, its labels equal away from
        the threshold."""
        path = str(PORT_FIXTURES / "mammography_std" / "model")
        X = mammography[0][:2000]
        scores, labels = run_model(IsolationForestConverter(path).convert(), {"features": X})
        model = load_model(path, device="cpu")
        port_scores = _scores(model, X, strategy="walk")
        assert np.abs(scores[:, 0] - port_scores).max() < 1e-5
        away = np.abs(port_scores - model.outlier_score_threshold) > 1e-5
        assert np.array_equal(labels[away, 0], (port_scores[away] >= model.outlier_score_threshold).astype(np.int32))


class TestExtendedConverter:
    @pytest.fixture(scope="class")
    def ext_saved(self, tmp_path_factory):
        rng = np.random.default_rng(2)
        X = rng.normal(size=(3000, 5)).astype(np.float32)
        X[:60] += 4.0
        model = ExtendedIsolationForest(
            num_estimators=20, contamination=0.02, extension_level=2, random_seed=5, device="cpu"
        ).fit(X)
        path = str(tmp_path_factory.mktemp("onnx_ext") / "model")
        model.save(path)
        return model, X, path

    def test_parity_vs_port_scorer(self, ext_saved):
        model, X, path = ext_saved
        scores, labels = run_model(ExtendedIsolationForestConverter(path).convert(), {"features": X})
        gather = _gather_scores(model, X)
        assert np.abs(scores[:, 0] - gather).max() < 1e-5
        disagree = labels[:, 0] != model.predict(torch.from_numpy(gather)).numpy()
        if disagree.any():
            assert np.all(np.abs(gather[disagree] - model.outlier_score_threshold) < 1e-5)

    def test_graph_shape(self, ext_saved):
        _, _, path = ext_saved
        parsed = parse_model(ExtendedIsolationForestConverter(path).convert())
        ops = [n["op_type"] for n in parsed["nodes"]]
        assert ops[0] == "MatMul" and ops[1] == "TreeEnsembleRegressor"
        assert "liftedWeights" in parsed["initializers"]

    def test_reference_extended_fixture(self, mammography):
        path = _FIXTURES / "savedExtendedIsolationForestModel"
        if not path.exists():
            pytest.skip("reference fixture unavailable")
        onnx_bytes = ExtendedIsolationForestConverter(str(path)).convert()
        X, _ = mammography
        scores, _ = run_model(onnx_bytes, {"features": X[:2000]})
        model = ExtendedIsolationForestModel.load(str(path), device="cpu")
        assert np.abs(scores[:, 0] - _gather_scores(model, X[:2000])).max() < 1e-5

    def test_reference_extended_fixture_kernel_boundary_bound(self, mammography):
        """The Spark-written EIF fixture against the port's path walk (K3's
        plain version): the boundary contract of the JAX test's native
        case."""
        path = _FIXTURES / "savedExtendedIsolationForestModel"
        if not path.exists():
            pytest.skip("reference fixture unavailable")
        onnx_bytes = ExtendedIsolationForestConverter(str(path)).convert()
        X, _ = mammography
        scores, _ = run_model(onnx_bytes, {"features": X[:2000]})
        model = ExtendedIsolationForestModel.load(str(path), device="cpu")
        _assert_within_boundary_bound(scores[:, 0], _scores(model, X[:2000], strategy="walk"))

    @pytest.mark.parametrize("strategy", ["gather", "walk", "dense"])
    def test_committed_fixture(self, mammography, strategy):
        """The JAX-written k = 6 EIF fixture: within 1e-5 of the port's gather
        walk, and under the boundary bound of the port's walk (K3) and dense
        (K4) strategies, whose dots take other orders."""
        path = str(PORT_FIXTURES / "mammography_eif" / "model")
        X = mammography[0][:2000]
        scores, _ = run_model(ExtendedIsolationForestConverter(path).convert(), {"features": X})
        model = load_model(path, device="cpu")
        if strategy == "gather":
            assert np.abs(scores[:, 0] - _gather_scores(model, X)).max() < 1e-5
        else:
            _assert_within_boundary_bound(scores[:, 0], _scores(model, X, strategy=strategy))

    def test_auto_dispatch(self, ext_saved, tmp_path):
        _, X, path = ext_saved
        out = tmp_path / "m.onnx"
        convert_and_save(path, str(out))
        scores, _ = run_model(out.read_bytes(), {"features": X[:100]})
        assert scores.shape == (100, 1)

    def test_standard_dir_rejected(self, saved_model):
        _, _, path = saved_model
        with pytest.raises(ValueError, match="Extended"):
            ExtendedIsolationForestConverter(path)


class TestProtoCodec:
    def test_varint_negative(self):
        data = proto.field_packed_varints(8, [-1, 0, 5])
        fields = proto.decode_message(data)
        assert proto.unpack_varints(fields[8][0][1]) == [-1, 0, 5]

    def test_attribute_round_trip(self):
        from isoforest_tpu_torch.onnx.runtime import _parse_attr

        name, val = _parse_attr(proto.attribute("modes", ["LEAF", "BRANCH_LT"]))
        assert name == "modes" and val == ["LEAF", "BRANCH_LT"]
        name, val = _parse_attr(proto.attribute("w", [1.5, -2.0]))
        np.testing.assert_allclose(val, [1.5, -2.0])
        name, val = _parse_attr(proto.attribute("n", 7))
        assert val == 7


def test_checker_imports_nothing_from_the_writer():
    """The checker's wire tables are its own: it must not import ``.proto``."""
    import ast

    import isoforest_tpu_torch.onnx.checker as checker

    tree = ast.parse(pathlib.Path(checker.__file__).read_text())
    names = [
        (node.module or "") + ":" + ",".join(a.name for a in node.names)
        for node in ast.walk(tree)
        if isinstance(node, ast.ImportFrom)
    ]
    assert not [n for n in names if "proto" in n], names


# --------------------------------------------------------------------------- #
# the independent checker (tests/test_onnx_checker.py on the port)
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def std_model_bytes(tmp_path_factory):
    rng = np.random.default_rng(2)
    X = rng.normal(size=(4000, 5)).astype(np.float32)
    X[:60] += 6.0
    model = IsolationForest(
        num_estimators=25, max_samples=128.0, contamination=0.02, random_seed=3, device="cpu"
    ).fit(X)
    path = tmp_path_factory.mktemp("m") / "model"
    model.save(str(path))
    return model, X, IsolationForestConverter(str(path)).convert()


class TestIndependentParse:
    def test_parses_writer_output(self, std_model_bytes):
        _, _, bts = std_model_bytes
        model = parse_model_independent(bts)
        assert model["ir_version"] == 10
        assert model["opsets"] == {"ai.onnx.ml": 1, "": 14}
        ops = [n["op_type"] for n in model["graph"]["nodes"]]
        assert "TreeEnsembleRegressor" in ops

    def test_check_model_passes(self, std_model_bytes):
        _, _, bts = std_model_bytes
        check_model(bts)

    def test_extended_converter_passes(self, tmp_path):
        rng = np.random.default_rng(4)
        X = rng.normal(size=(2000, 4)).astype(np.float32)
        model = ExtendedIsolationForest(
            num_estimators=10, max_samples=64.0, extension_level=2, device="cpu"
        ).fit(X)
        model.save(str(tmp_path / "m"))
        check_model(ExtendedIsolationForestConverter(str(tmp_path / "m")).convert())


class TestIndependentEvaluation:
    def test_matches_model_scores(self, std_model_bytes):
        model, X, bts = std_model_bytes
        got = reference_scores(bts, X[:800])[:, 0]
        want = _scores(model, X[:800])
        assert np.abs(got - want).max() < 1e-5

    def test_matches_bundled_runtime(self, std_model_bytes):
        _, X, bts = std_model_bytes
        ours, _ = run_model(bts, {"features": X[:500]})
        independent = reference_scores(bts, X[:500])
        assert np.abs(ours[:, 0] - independent[:, 0]).max() < 1e-6


def _tiny_valid_graph(ensemble_attrs=None, opsets=None):
    """Hand-built minimal valid model the mutations below perturb."""
    attrs = dict(
        n_targets=1,
        aggregate_function="AVERAGE",
        post_transform="NONE",
        nodes_treeids=[0, 0, 0],
        nodes_nodeids=[0, 1, 2],
        nodes_featureids=[0, 0, 0],
        nodes_values=[0.5, 0.0, 0.0],
        nodes_modes=["BRANCH_LT", "LEAF", "LEAF"],
        nodes_truenodeids=[1, 0, 0],
        nodes_falsenodeids=[2, 0, 0],
        target_treeids=[0, 0],
        target_nodeids=[1, 2],
        target_ids=[0, 0],
        target_weights=[1.0, 2.0],
    )
    attrs.update(ensemble_attrs or {})
    ensemble = proto.node(
        "TreeEnsembleRegressor",
        ["features"],
        ["path"],
        domain="ai.onnx.ml",
        attributes=[proto.attribute(k, v) for k, v in attrs.items()],
    )
    graph = proto.graph(
        nodes=[ensemble],
        name="tiny",
        inputs=[proto.value_info("features", proto.FLOAT, ["batch", 2])],
        outputs=[proto.value_info("path", proto.FLOAT, ["batch", 1])],
        initializers=[],
    )
    return proto.model(
        graph,
        opset_imports=opsets if opsets is not None else [("ai.onnx.ml", 1), ("", 14)],
    )


class TestCheckerRejects:
    def test_valid_baseline(self):
        check_model(_tiny_valid_graph())

    def test_truncated_bytes_raise_checkerror(self):
        bts = _tiny_valid_graph()
        for cut in (len(bts) - 1, len(bts) // 2, 3):
            with pytest.raises(CheckError):
                check_model(bts[:cut])

    def test_missing_opset(self):
        with pytest.raises(CheckError, match="not in opset_import"):
            check_model(_tiny_valid_graph(opsets=[("", 14)]))

    def test_mismatched_node_arrays(self):
        with pytest.raises(CheckError, match="disagree in length"):
            check_model(_tiny_valid_graph(ensemble_attrs={"nodes_featureids": [0, 0]}))

    def test_invalid_mode(self):
        with pytest.raises(CheckError, match="nodes_modes"):
            check_model(_tiny_valid_graph(ensemble_attrs={"nodes_modes": ["BRANCH_XX", "LEAF", "LEAF"]}))

    def test_dangling_child(self):
        with pytest.raises(CheckError, match="nonexistent child"):
            check_model(_tiny_valid_graph(ensemble_attrs={"nodes_truenodeids": [9, 0, 0]}))

    def test_target_to_missing_node(self):
        with pytest.raises(CheckError, match="nonexistent node"):
            check_model(_tiny_valid_graph(ensemble_attrs={"target_nodeids": [1, 9]}))

    def test_cyclic_node_table(self):
        with pytest.raises(CheckError, match="cyclic|reached twice"):
            check_model(_tiny_valid_graph(ensemble_attrs={"nodes_falsenodeids": [0, 0, 0]}))

    def test_unreachable_node(self):
        with pytest.raises(CheckError, match="unreachable"):
            check_model(_tiny_valid_graph(ensemble_attrs={"nodes_modes": ["LEAF", "LEAF", "LEAF"]}))

    def test_converging_edges(self):
        with pytest.raises(CheckError, match="reached twice"):
            check_model(_tiny_valid_graph(ensemble_attrs={"nodes_falsenodeids": [1, 0, 0]}))

    def test_bad_aggregate(self):
        with pytest.raises(CheckError, match="aggregate_function"):
            check_model(_tiny_valid_graph(ensemble_attrs={"aggregate_function": "MEDIAN"}))

    def test_undefined_input_not_ssa(self):
        neg = proto.node("Neg", ["ghost"], ["out"])
        graph = proto.graph(
            nodes=[neg],
            name="bad",
            inputs=[proto.value_info("features", proto.FLOAT, ["batch", 2])],
            outputs=[proto.value_info("out", proto.FLOAT, ["batch", 2])],
            initializers=[],
        )
        with pytest.raises(CheckError, match="not defined before use"):
            check_model(proto.model(graph, opset_imports=[("", 14)]))

    def test_evaluator_semantics_tiny(self):
        bts = _tiny_valid_graph()
        X = np.array([[0.0, 0.0], [1.0, 0.0]], np.float32)
        out = reference_scores(bts, X)
        assert out[0, 0] == 1.0 and out[1, 0] == 2.0


def _tiny_graph_parts():
    return (
        proto.value_info("features", proto.FLOAT, ["batch", 2]),
        proto.value_info("path", proto.FLOAT, ["batch", 1]),
    )


def _one_node_model(node, name="g", inputs=None, outputs=None, opsets=(("", 14),), ir_version=None):
    g_in, g_out = _tiny_graph_parts()
    graph = proto.graph(
        nodes=[node] if node is not None else [],
        name=name,
        inputs=[g_in] if inputs is None else inputs,
        outputs=[g_out] if outputs is None else outputs,
        initializers=[],
    )
    kw = {} if ir_version is None else {"ir_version": ir_version}
    return proto.model(graph, opset_imports=list(opsets), **kw)


class TestCheckerRejectsModelLevel:
    def test_bad_ir_version(self):
        with pytest.raises(CheckError, match="ir_version"):
            check_model(_one_node_model(proto.node("Neg", ["features"], ["path"]), ir_version=99))

    def test_no_opsets(self):
        with pytest.raises(CheckError, match="no opset_import"):
            check_model(_one_node_model(proto.node("Neg", ["features"], ["path"]), opsets=()))

    def test_zero_opset_version(self):
        with pytest.raises(CheckError, match="no valid version"):
            check_model(_one_node_model(proto.node("Neg", ["features"], ["path"]), opsets=(("", 0),)))

    def test_empty_graph(self):
        with pytest.raises(CheckError, match="no nodes"):
            check_model(_one_node_model(None))

    def test_empty_graph_name(self):
        with pytest.raises(CheckError, match="graph name"):
            check_model(_one_node_model(proto.node("Neg", ["features"], ["path"]), name=""))

    def test_missing_outputs(self):
        with pytest.raises(CheckError, match="declare inputs and outputs"):
            check_model(_one_node_model(proto.node("Neg", ["features"], ["path"]), outputs=[]))

    def test_empty_value_name(self):
        with pytest.raises(CheckError, match="empty name"):
            check_model(_one_node_model(proto.node("Neg", ["features"], ["path"]),
                                        inputs=[proto.value_info("", proto.FLOAT, ["batch", 2])]))

    def test_invalid_elem_type(self):
        with pytest.raises(CheckError, match="invalid elem_type"):
            check_model(_one_node_model(proto.node("Neg", ["features"], ["path"]),
                                        inputs=[proto.value_info("features", 99, ["batch", 2])]))

    def test_unexpected_op(self):
        with pytest.raises(CheckError, match="unexpected op"):
            check_model(_one_node_model(proto.node("Relu", ["features"], ["path"])))

    def test_wrong_domain(self):
        with pytest.raises(CheckError, match="domain"):
            check_model(_one_node_model(proto.node("Neg", ["features"], ["path"], domain="ai.onnx.ml"),
                                        opsets=(("ai.onnx.ml", 1), ("", 14))))

    def test_bad_arity(self):
        with pytest.raises(CheckError, match="arity"):
            check_model(_one_node_model(proto.node("Neg", ["features", "features"], ["path"])))

    def test_missing_required_attr(self):
        with pytest.raises(CheckError, match="missing required attribute"):
            check_model(_one_node_model(proto.node("Cast", ["features"], ["path"])))

    def test_duplicate_output_names(self):
        g_in, g_out = _tiny_graph_parts()
        n1 = proto.node("Neg", ["features"], ["path"])
        n2 = proto.node("Neg", ["features"], ["path"])
        graph = proto.graph(nodes=[n1, n2], name="g", inputs=[g_in], outputs=[g_out], initializers=[])
        with pytest.raises(CheckError, match="duplicate output"):
            check_model(proto.model(graph, opset_imports=[("", 14)]))

    def test_cast_invalid_dtype(self):
        cast = proto.node("Cast", ["features"], ["path"], attributes=[proto.attribute("to", 99)])
        with pytest.raises(CheckError, match="invalid 'to'"):
            check_model(_one_node_model(cast))

    def test_unproduced_graph_output(self):
        with pytest.raises(CheckError, match="never produced"):
            check_model(_one_node_model(proto.node("Neg", ["features"], ["mid"]),
                                        outputs=[proto.value_info("ghost", proto.FLOAT, ["batch", 1])]))

    def test_bad_post_transform(self):
        with pytest.raises(CheckError, match="post_transform"):
            check_model(_tiny_valid_graph(ensemble_attrs={"post_transform": "RELU"}))

    def test_target_ids_out_of_range(self):
        with pytest.raises(CheckError, match="target_ids"):
            check_model(_tiny_valid_graph(ensemble_attrs={"target_ids": [0, 5]}))

    def test_tree_without_root(self):
        with pytest.raises(CheckError, match="root"):
            check_model(
                _tiny_valid_graph(
                    ensemble_attrs={
                        "nodes_treeids": [0, 0, 0, 1],
                        "nodes_nodeids": [0, 1, 2, 5],
                        "nodes_featureids": [0, 0, 0, 0],
                        "nodes_values": [0.5, 0.0, 0.0, 0.0],
                        "nodes_modes": ["BRANCH_LT", "LEAF", "LEAF", "LEAF"],
                        "nodes_truenodeids": [1, 0, 0, 0],
                        "nodes_falsenodeids": [2, 0, 0, 0],
                    }
                )
            )

    def test_cyclic_node_table(self):
        with pytest.raises(CheckError, match="cycl|reached twice"):
            check_model(
                _tiny_valid_graph(
                    ensemble_attrs={
                        "nodes_modes": ["BRANCH_LT", "BRANCH_LT", "LEAF"],
                        "nodes_truenodeids": [1, 0, 0],
                        "nodes_falsenodeids": [2, 2, 0],
                    }
                )
            )


class TestEvaluatorBranchModes:
    def test_branch_leq_semantics(self):
        bts = _tiny_valid_graph(ensemble_attrs={"nodes_modes": ["BRANCH_LEQ", "LEAF", "LEAF"]})
        X = np.array([[0.5, 0.0], [0.51, 0.0]], np.float32)
        out = reference_scores(bts, X)
        assert out[0, 0] == 1.0 and out[1, 0] == 2.0
        lt = reference_scores(_tiny_valid_graph(), X)
        assert lt[0, 0] == 2.0

    def test_extended_model_full_graph_eval(self, tmp_path):
        rng = np.random.default_rng(11)
        X = rng.normal(size=(1500, 4)).astype(np.float32)
        model = ExtendedIsolationForest(
            num_estimators=8, max_samples=64.0, extension_level=2, random_seed=5, device="cpu"
        ).fit(X)
        model.save(str(tmp_path / "m"))
        bts = ExtendedIsolationForestConverter(str(tmp_path / "m")).convert()
        ours, _ = run_model(bts, {"features": X[:400]})
        independent = reference_scores(bts, X[:400])
        assert np.abs(ours[:, 0] - independent[:, 0]).max() < 1e-6
        assert np.abs(independent[:, 0] - _gather_scores(model, X[:400])).max() < 1e-5


# --------------------------------------------------------------------------- #
# across the packages
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def saved_dirs(saved_model):
    """Both committed fixtures (written by the JAX package) and a port-written save."""
    return {
        "mammography_std": str(PORT_FIXTURES / "mammography_std" / "model"),
        "mammography_eif": str(PORT_FIXTURES / "mammography_eif" / "model"),
        "port_written": saved_model[2],
    }


@pytest.fixture(scope="module")
def both_bytes(saved_dirs):
    import isoforest_tpu.onnx as jax_onnx
    import isoforest_tpu_torch.onnx as port_onnx

    out = {}
    for kind, path in saved_dirs.items():
        converter = "ExtendedIsolationForestConverter" if kind.endswith("eif") else "IsolationForestConverter"
        out[kind] = (getattr(jax_onnx, converter)(path).convert(), getattr(port_onnx, converter)(path).convert())
    return out


KINDS = ["mammography_std", "mammography_eif", "port_written"]


@pytest.mark.parametrize("kind", KINDS)
def test_the_ports_converter_writes_the_jax_converters_bytes(both_bytes, kind):
    jax_bytes, port_bytes = both_bytes[kind]
    assert port_bytes == jax_bytes


@pytest.mark.parametrize("kind", KINDS)
def test_each_checker_accepts_the_other_packages_bytes(both_bytes, kind):
    from isoforest_tpu.onnx.checker import check_model as jax_check_model

    jax_bytes, port_bytes = both_bytes[kind]
    check_model(jax_bytes)
    jax_check_model(port_bytes)


@pytest.mark.parametrize("kind", KINDS)
def test_each_runtime_gives_the_other_runtimes_outputs(both_bytes, kind, mammography):
    from isoforest_tpu.onnx.checker import reference_scores as jax_reference_scores
    from isoforest_tpu.onnx.runtime import run_model as jax_run_model

    jax_bytes, port_bytes = both_bytes[kind]
    width = parse_model(port_bytes)["initializers"].get("liftedWeights", np.zeros((6, 1))).shape[0]
    X = mammography[0][:1000] if kind != "port_written" else np.random.default_rng(3).normal(
        size=(1000, 6)).astype(np.float32)
    assert X.shape[1] == width
    jax_out = jax_run_model(jax_bytes, {"features": X})
    port_out = run_model(port_bytes, {"features": X})
    for a, b in zip(jax_out, port_out):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    np.testing.assert_array_equal(reference_scores(port_bytes, X[:200]), jax_reference_scores(jax_bytes, X[:200]))
