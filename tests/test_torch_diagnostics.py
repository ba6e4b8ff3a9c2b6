"""The port's forest diagnostics (``isoforest_tpu_torch/telemetry/diagnostics.py``)
against the JAX package's, on the CPU.

Tolerances: every integer and every structural count equal; floats within
1e-6 relative. The JAX package reads its packed value plane and the port
its own leaf table ``depth + c(n)``; both compute ``c(n)`` in float32 with
a ``log`` that may differ by a few ulps between XLA and torch.
"""

from __future__ import annotations

import math
import pathlib

import numpy as np
import pytest

from isoforest_tpu.io import persistence as jpersistence
from isoforest_tpu.models import IsolationForestModel as JaxModel
from isoforest_tpu.ops.tree_growth import StandardForest as JaxForest
from isoforest_tpu.utils.params import IsolationForestParams as JaxParams
from isoforest_tpu_torch import ExtendedIsolationForest, IsolationForest, load_model, telemetry
from isoforest_tpu_torch.io.interop import model_from_arrays
from isoforest_tpu_torch.telemetry.diagnostics import publish_gauges
from isoforest_tpu_torch.testing import torch_threads

RESOURCES = pathlib.Path(__file__).parent / "resources" / "torch_port"
FIXTURES = {"standard": RESOURCES / "mammography_std" / "model", "extended": RESOURCES / "mammography_eif" / "model"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run beside other test processes
    (``testing.torch_threads``)."""
    with torch_threads(1):
        yield


def _assert_close(got, want, where="diag"):
    assert type(got) is type(want) or {type(got), type(want)} <= {int, float}, where
    if isinstance(want, dict):
        assert got.keys() == want.keys(), where
        for k in want:
            _assert_close(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, float):
        assert math.isclose(got, want, rel_tol=1e-6, abs_tol=1e-6 * 1e-3), (where, got, want)
    else:
        assert got == want, (where, got, want)


@pytest.mark.parametrize("kind", sorted(FIXTURES))
def test_fixture_diagnostics_equal_the_jax_packages(kind):
    got = load_model(str(FIXTURES[kind]), device="cpu").diagnostics()
    want = jpersistence.load_model(str(FIXTURES[kind])).diagnostics()
    _assert_close(got, want)
    assert got["model"] == kind


@pytest.mark.parametrize("kind,cls", [("standard", IsolationForest), ("extended", ExtendedIsolationForest)])
def test_fitted_diagnostics_equal_the_jax_packages(kind, cls, tmp_path, mammography):
    model = cls(num_estimators=10, max_samples=32.0, max_features=0.5, random_seed=4, device="cpu").fit(
        mammography[0][:1500])
    model.save(str(tmp_path / "m"))
    got = model.diagnostics()
    _assert_close(got, jpersistence.load_model(str(tmp_path / "m")).diagnostics())
    assert got["nodes"]["leaves"] == got["nodes"]["internal"] + got["num_trees"]


def test_hand_built_forest():
    """One tree: a root split on feature 0, a leaf of 3, a split on feature
    2 with leaves of 2 and 3 (tests/test_monitor.py::_hand_built_model)."""
    feature = np.full((1, 7), -1, np.int32)
    threshold = np.zeros((1, 7), np.float32)
    num_instances = np.full((1, 7), -1, np.int32)
    feature[0, 0], threshold[0, 0] = 0, 0.5
    num_instances[0, 1] = 3
    feature[0, 2], threshold[0, 2] = 2, 1.5
    num_instances[0, 5] = 2
    num_instances[0, 6] = 3
    port = model_from_arrays(feature, threshold, num_instances, num_samples=8, num_features=3, total_num_features=3,
                             device="cpu")
    ref = JaxModel(forest=JaxForest(feature, threshold, num_instances), params=JaxParams(num_estimators=1),
                   num_samples=8, num_features=3, total_num_features=3)
    got = port.diagnostics()
    _assert_close(got, ref.diagnostics())
    assert got["nodes"] == {"internal": 2, "leaves": 3, "slots": 7, "occupancy": round(5 / 7, 6)}
    assert got["feature_split_usage"] == {"0": 1, "2": 1}
    assert got["leaf_size"]["histogram"] == {"2-3": 3}
    assert got["leaf_depth"]["weighted_mean"] == pytest.approx(13 / 8)


def test_publish_gauges():
    telemetry.reset()
    diag = load_model(str(FIXTURES["standard"]), device="cpu").diagnostics()
    publish_gauges(diag)
    assert telemetry.gauge("isoforest_forest_trees").value() == 100
    depth = telemetry.gauge("isoforest_forest_tree_depth", labelnames=("stat",))
    assert depth.value(stat="max") == diag["tree_depth"]["max"]
    usage = telemetry.gauge("isoforest_forest_feature_split_usage", labelnames=("feature",))
    assert sum(usage.value(feature=f) for f in diag["feature_split_usage"]) == diag["nodes"]["internal"]
    telemetry.reset()
