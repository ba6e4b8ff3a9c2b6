"""Extended (EIF) model files across the two packages: what the JAX package
writes, the PyTorch port reads to equal hyperplanes and metadata
(``io/avro.py``, ``io/persistence.py``), on the CPU."""

from __future__ import annotations

import json
import pathlib
import shutil

import numpy as np
import pytest
import torch

from isoforest_tpu.io import avro as javro
from isoforest_tpu.io import persistence as jpersistence
from isoforest_tpu.models import ExtendedIsolationForestModel as JaxModel
from isoforest_tpu.resilience import manifest as jmanifest
from isoforest_tpu.ops.ext_growth import ExtendedForest as JaxForest
from isoforest_tpu.utils.params import ExtendedIsolationForestParams as JaxParams
from isoforest_tpu.utils.params import resolve_extension_level as jax_resolve
from isoforest_tpu_torch import ExtendedIsolationForestModel, IsolationForestModel, load_model
from isoforest_tpu_torch.io import avro as tavro
from isoforest_tpu_torch.io import persistence as tpersistence
from isoforest_tpu_torch.testing import random_extended_forest
from isoforest_tpu_torch.utils.params import ExtendedIsolationForestParams, resolve_extension_level

RESOURCES = pathlib.Path(__file__).parent / "resources" / "torch_port"
FIXTURE = RESOURCES / "mammography_eif" / "model"


def _assert_same_forest(port_model, jax_model):
    jf, tf = jax_model.forest, port_model.forest
    assert tf.indices.dtype == torch.int32 and tf.weights.dtype == torch.float32
    assert tf.offset.dtype == torch.float32 and tf.num_instances.dtype == torch.int32
    assert tf.device.type == "cpu"
    np.testing.assert_array_equal(tf.indices.numpy(), np.asarray(jf.indices))
    np.testing.assert_array_equal(tf.weights.numpy(), np.asarray(jf.weights, np.float32))
    np.testing.assert_array_equal(tf.offset.numpy(), np.asarray(jf.offset, np.float32))
    np.testing.assert_array_equal(tf.num_instances.numpy(), np.asarray(jf.num_instances))


def _assert_same_metadata(port_model, jax_model):
    assert isinstance(port_model, ExtendedIsolationForestModel)
    assert port_model.extension_level == jax_model.extension_level
    assert port_model.num_samples == jax_model.num_samples
    assert port_model.num_features == jax_model.num_features
    assert port_model.total_num_features == jax_model.total_num_features
    assert port_model.outlier_score_threshold == jax_model.outlier_score_threshold
    assert port_model.uid == jax_model.uid
    assert port_model.params.to_param_map() == jax_model.params.to_param_map()


def test_committed_fixture_loads_equal_in_both_packages():
    port = load_model(str(FIXTURE), device="cpu")
    ref = JaxModel.load(str(FIXTURE))
    assert port.forest.num_trees == 100 and port.forest.max_nodes == 511 and port.forest.k == 6
    assert port.extension_level == 5
    _assert_same_forest(port, ref)
    _assert_same_metadata(port, ref)


@pytest.mark.parametrize("k,unused_p", [(3, 0.0), (5, 0.4)])
def test_model_saved_by_jax_package_loads_equal(tmp_path, k, unused_p):
    """Narrower nodes (unused coordinates) are written without them and
    read back padded with -1, in both packages."""
    rng = np.random.default_rng(k)
    forest = JaxForest(*random_extended_forest(rng, trees=6, height=4, features=5, k=k, unused_p=unused_p))
    ref = JaxModel(
        forest=forest,
        params=JaxParams(num_estimators=6, max_samples=30.0, contamination=0.1),
        num_samples=30,
        num_features=5,
        extension_level=k - 1,
        total_num_features=5,
    ).set_outlier_score_threshold(0.57)
    ref.save(str(tmp_path / "m"))
    port = load_model(str(tmp_path / "m"), device="cpu")
    saved = JaxModel.load(str(tmp_path / "m"))
    _assert_same_forest(port, saved)
    _assert_same_metadata(port, saved)
    np.testing.assert_array_equal(port.forest.offset.numpy(), np.asarray(forest.offset))


def test_extended_node_table_decodes_equal():
    """The port's Avro reader on the ``extendedNodeData`` schema: arrays of
    int and float, the record union, in every codec the model files use."""
    (data_file,) = (FIXTURE / "data").glob("*.avro")
    schema, ref = javro.read_container(str(data_file))
    got_schema, got = tavro.read_container(str(data_file))
    assert got == ref and got_schema == schema
    node = next(r["extendedNodeData"] for r in got if r["extendedNodeData"]["leftChild"] >= 0)
    assert len(node["indices"]) == 6 and len(node["weights"]) == 6


@pytest.mark.parametrize("codec", ["null", "deflate"])
def test_codecs_read_equal(tmp_path, codec):
    model_dir = tmp_path / "m"
    shutil.copytree(FIXTURE, model_dir)
    (data_file,) = (model_dir / "data").glob("*.avro")
    schema, records = javro.read_container(str(data_file))
    data_file.unlink()
    javro.write_container(str(model_dir / "data" / "part-00000-x-c000.avro"), schema, records, codec=codec)
    jmanifest.write(str(model_dir))  # sealed anew, as a save would
    port = load_model(str(model_dir), device="cpu")
    _assert_same_forest(port, JaxModel.load(str(FIXTURE)))


def test_missing_extension_level_falls_back_to_k_minus_1(tmp_path):
    model_dir = tmp_path / "m"
    shutil.copytree(FIXTURE, model_dir)
    meta = model_dir / "metadata" / "part-00000"
    doc = json.loads(meta.read_text())
    del doc["paramMap"]["extensionLevel"]
    meta.write_text(json.dumps(doc) + "\n")
    jmanifest.write(str(model_dir))  # sealed anew, as a save would
    port = load_model(str(model_dir), device="cpu")
    assert port.extension_level == 5 and port.params.extension_level is None


def test_threshold_and_params_restore():
    port = ExtendedIsolationForestModel.load(str(FIXTURE), device="cpu")
    assert port.outlier_score_threshold == pytest.approx(0.6251140236854553, abs=0)
    assert port.params.contamination == 0.02 and port.params.extension_level == 5


def test_load_model_dispatches_on_the_metadata_class():
    assert type(load_model(str(FIXTURE), device="cpu")) is ExtendedIsolationForestModel
    std = RESOURCES / "mammography_std" / "model"
    assert type(load_model(str(std), device="cpu")) is IsolationForestModel
    with pytest.raises(ValueError, match="metadata class mismatch"):
        ExtendedIsolationForestModel.load(str(std), device="cpu")
    with pytest.raises(ValueError, match="metadata class mismatch"):
        IsolationForestModel.load(str(FIXTURE), device="cpu")


def test_extension_level_params_match_jax_package():
    assert resolve_extension_level(None, 6) == jax_resolve(None, 6) == 5
    assert resolve_extension_level(2, 6) == jax_resolve(2, 6) == 2
    for impl in (resolve_extension_level, jax_resolve):
        with pytest.raises(ValueError, match="exceeds maximum 5"):
            impl(6, 6)
    params = {"numEstimators": 10, "maxSamples": 64.0, "extensionLevel": 3, "contamination": 0.1}
    assert ExtendedIsolationForestParams.from_param_map(params).to_param_map() == (
        JaxParams.from_param_map(params).to_param_map()
    )
    with pytest.raises(ValueError, match="extensionLevel must be an int >= 0"):
        ExtendedIsolationForestParams(extension_level=-1)


def test_node_records_to_forest():
    """Pre-order extended records become heap slots; the Double offset
    rounds to float32; leaves keep -1 coordinates."""
    records = [
        {"id": 0, "leftChild": 1, "rightChild": 2, "indices": [0, 2], "weights": [0.6, -0.8],
         "offset": 0.1, "numInstances": -1},
        {"id": 1, "leftChild": -1, "rightChild": -1, "indices": [], "weights": [], "offset": 0.0,
         "numInstances": 3},
        {"id": 2, "leftChild": -1, "rightChild": -1, "indices": [], "weights": [], "offset": 0.0,
         "numInstances": 0},
    ]
    forest = tpersistence.records_to_extended_forest([records])
    ref = jpersistence.records_to_extended_forest([records])
    for got, want in zip(forest, ref):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert forest.k == 2 and forest.height == 1
    assert forest.offset[0, 0].item() == np.float32(0.1)
