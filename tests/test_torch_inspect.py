"""The port's tree dumps (``isoforest_tpu_torch/utils/inspect.py``) against
the JAX package's, string for string, on the CPU: both committed fixtures,
trees 0, 1 and the last, and the JVM number rendering on its edge values."""

from __future__ import annotations

import pathlib

import numpy as np
import pytest

from isoforest_tpu.models import ExtendedIsolationForestModel as JaxExtendedModel
from isoforest_tpu.models import IsolationForestModel as JaxModel
from isoforest_tpu.utils import inspect as jinspect
from isoforest_tpu_torch import IsolationForest, load_model
from isoforest_tpu_torch.utils import inspect

PORT_DIR = pathlib.Path(__file__).parent / "resources" / "torch_port"
FIXTURES = {"std": (PORT_DIR / "mammography_std" / "model", JaxModel),
            "eif": (PORT_DIR / "mammography_eif" / "model", JaxExtendedModel)}


@pytest.fixture(scope="module")
def models():
    return {kind: (load_model(str(path), device="cpu"), cls.load(str(path))) for kind, (path, cls) in FIXTURES.items()}


@pytest.mark.parametrize("tree", [0, 1, -1], ids=["first", "second", "last"])
@pytest.mark.parametrize("kind", ["std", "eif"])
def test_tree_strings_equal_the_jax_packages(models, kind, tree):
    port, ref = models[kind]
    tree_id = tree % port.forest.num_trees
    got = inspect.tree_structure_string(port, tree_id)
    assert got == jinspect.tree_structure_string(ref, tree_id)
    assert got.startswith("ExtendedInternalNode(" if kind == "eif" else "InternalNode(")


def test_out_of_range_tree_raises_as_the_jax_package(models):
    port, ref = models["std"]
    for tree_id in (-1, port.forest.num_trees):
        with pytest.raises(IndexError) as ours:
            inspect.tree_structure_string(port, tree_id)
        with pytest.raises(IndexError) as theirs:
            jinspect.tree_structure_string(ref, tree_id)
        assert str(ours.value) == str(theirs.value)


def test_a_fitted_models_tree_renders(mammography):
    model = IsolationForest(num_estimators=2, max_samples=16.0, random_seed=1, device="cpu").fit(
        mammography[0][:200], baseline=False)
    arrays = [a[0].numpy() for a in model.forest]
    assert inspect.tree_structure_string(model, 0) == jinspect.standard_tree_string(*arrays)


_DOUBLES = [0.8253754481933855, -0.023960880394378714, 1.0, -2.0, 0.0, -0.0, 1e7, 12345678.0, 0.001, 0.0001,
            -3.5e-8, 9999999.5, 1e-300, 5e-324, 1.7976931348623157e308, 123.456, 1e22, 0.1]
_FLOATS = [0.3793424, -0.16987173, 1.0, 0.5, 0.0, -0.0, 1e7, 1e-3, 9.999999e-4, 3.4028235e38, 1.4e-45, 1.17549435e-38,
           16777217.0, 0.1]


@pytest.mark.parametrize("value", _DOUBLES)
def test_java_double_rendering_equals_the_jax_packages(value):
    assert inspect.java_double_str(value) == jinspect.java_double_str(value)


@pytest.mark.parametrize("value", _FLOATS)
def test_java_float_rendering_equals_the_jax_packages(value):
    v = np.float32(value)
    assert inspect.java_float_str(v) == jinspect.java_float_str(v)
