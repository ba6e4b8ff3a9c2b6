"""Model files across the two packages: what the JAX package writes, the
PyTorch port reads to equal arrays and metadata (``io/avro.py``,
``io/persistence.py``), on the CPU."""

from __future__ import annotations

import json
import pathlib
import shutil
import struct
import zlib

import numpy as np
import pytest
import torch

from isoforest_tpu.io import avro as javro
from isoforest_tpu.io import persistence as jpersistence
from isoforest_tpu.models import IsolationForestModel as JaxModel
from isoforest_tpu.resilience import manifest as jmanifest
from isoforest_tpu.ops.tree_growth import StandardForest as JaxForest
from isoforest_tpu.utils.params import IsolationForestParams as JaxParams
from isoforest_tpu_torch import IsolationForestModel, load_model
from isoforest_tpu_torch.io import avro as tavro
from isoforest_tpu_torch.io import persistence as tpersistence
from isoforest_tpu_torch.testing import random_heap_forest

FIXTURE = pathlib.Path(__file__).parent / "resources" / "torch_port" / "mammography_std" / "model"


def _assert_same_forest(port_model, jax_model):
    jf = jax_model.forest
    tf = port_model.forest
    assert tf.feature.dtype == torch.int32 and tf.threshold.dtype == torch.float32
    assert tf.num_instances.dtype == torch.int32 and tf.device.type == "cpu"
    np.testing.assert_array_equal(tf.feature.numpy(), np.asarray(jf.feature))
    np.testing.assert_array_equal(tf.threshold.numpy(), np.asarray(jf.threshold, np.float32))
    np.testing.assert_array_equal(tf.num_instances.numpy(), np.asarray(jf.num_instances))


def _assert_same_metadata(port_model, jax_model):
    assert port_model.num_samples == jax_model.num_samples
    assert port_model.num_features == jax_model.num_features
    assert port_model.total_num_features == jax_model.total_num_features
    assert port_model.outlier_score_threshold == jax_model.outlier_score_threshold
    assert port_model.uid == jax_model.uid
    assert port_model.params.to_param_map() == jax_model.params.to_param_map()


def test_committed_fixture_loads_equal_in_both_packages():
    port = load_model(str(FIXTURE), device="cpu")
    ref = JaxModel.load(str(FIXTURE))
    assert port.forest.num_trees == 100 and port.forest.max_nodes == 511
    _assert_same_forest(port, ref)
    _assert_same_metadata(port, ref)


def test_model_saved_by_jax_package_loads_equal(tmp_path):
    rng = np.random.default_rng(3)
    forest = JaxForest(*random_heap_forest(rng, trees=7, height=5, features=4))
    ref = JaxModel(
        forest=forest,
        params=JaxParams(num_estimators=7, max_samples=40.0, contamination=0.1),
        num_samples=40,
        num_features=4,
        total_num_features=4,
    ).set_outlier_score_threshold(0.55)
    ref.save(str(tmp_path / "m"))
    port = load_model(str(tmp_path / "m"), device="cpu")
    _assert_same_forest(port, ref)
    _assert_same_metadata(port, ref)


@pytest.mark.parametrize("codec", ["null", "deflate"])
def test_codecs_read_equal(tmp_path, codec):
    """A model whose node table the JAX package re-encodes with ``codec``
    loads to the same forest, and the container decodes to equal records."""
    model_dir = tmp_path / "m"
    shutil.copytree(FIXTURE, model_dir)
    (data_file,) = (model_dir / "data").glob("*.avro")
    schema, records = javro.read_container(str(data_file))
    data_file.unlink()
    javro.write_container(str(model_dir / "data" / "part-00000-x-c000.avro"), schema, records, codec=codec)
    jmanifest.write(str(model_dir))  # sealed anew, as a save would
    _, port_records = tavro.read_container(str(model_dir / "data" / "part-00000-x-c000.avro"))
    assert port_records == records
    port = load_model(str(model_dir), device="cpu")
    _assert_same_forest(port, JaxModel.load(str(FIXTURE)))


def _snappy_literals(data: bytes) -> bytes:
    """Literal-only snappy stream (valid, uncompressed)."""
    out = bytearray()
    n = len(data)
    while True:  # varint length
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            break
    for i in range(0, len(data), 60):
        chunk = data[i : i + 60]
        out.append((len(chunk) - 1) << 2)
        out += chunk
    return bytes(out)


def test_snappy_container_reads_equal(tmp_path):
    rng = np.random.default_rng(5)
    records = [
        {"treeID": 0, "nodeData": {"id": i, "leftChild": -1, "rightChild": -1,
                                   "splitAttribute": -1, "splitValue": float(rng.normal()),
                                   "numInstances": int(rng.integers(0, 9))}}
        for i in range(40)
    ]
    schema = jpersistence.STANDARD_SCHEMA
    body = bytearray()
    for rec in records:
        javro.encode_value(schema, rec, body)
    block = _snappy_literals(bytes(body)) + struct.pack(">I", zlib.crc32(bytes(body)) & 0xFFFFFFFF)
    sync = bytes(range(16))
    path = tmp_path / "snappy.avro"
    with open(path, "wb") as fh:
        javro._write_header(fh, json.dumps(schema), "snappy", sync)
        fh.write(javro.encode_long(len(records)) + javro.encode_long(len(block)) + block + sync)
    _, ref = javro.read_container(str(path))
    _, got = tavro.read_container(str(path))
    assert got == ref == records


@pytest.mark.parametrize(
    "stream,expected",
    [
        # literal "abcd", then a 2-byte-offset copy of 12 overlapping bytes
        (b"\x10\x0cabcd\x2e\x04\x00", b"abcd" * 4),
        # literal "xyz", then a 1-byte-offset copy of 8 bytes at offset 3
        (b"\x0b\x08xyz\x11\x03", b"xyz" + b"xyzxyzxy"),
    ],
)
def test_snappy_copies_match_jax(stream, expected):
    assert tavro.snappy_decompress(stream) == javro.snappy_decompress(stream) == expected


def test_corrupt_streams_raise():
    with pytest.raises(ValueError, match="zero copy offset"):
        tavro.snappy_decompress(b"\x08\x00a\x0d\x00")
    with pytest.raises(ValueError, match="length mismatch"):
        tavro.snappy_decompress(b"\x05\x00a")


def test_node_table_contract():
    with pytest.raises(ValueError, match="not 0..N-1"):
        tpersistence.records_to_standard_forest(
            [[{"id": 1, "leftChild": -1, "rightChild": -1, "splitAttribute": -1,
               "splitValue": 0.0, "numInstances": 3}]]
        )
    # a chain deeper than any valid tree is refused before it is allocated
    chain = [{"id": i, "leftChild": i + 1, "rightChild": i + 2, "splitAttribute": 0,
              "splitValue": 0.0, "numInstances": -1} for i in range(0, 60, 2)]
    chain += [{"id": i, "leftChild": -1, "rightChild": -1, "splitAttribute": -1,
               "splitValue": 0.0, "numInstances": 1} for i in range(1, 61, 2)]
    chain.append({"id": 60, "leftChild": -1, "rightChild": -1, "splitAttribute": -1,
                  "splitValue": 0.0, "numInstances": 1})
    with pytest.raises(ValueError, match="refusing to materialise"):
        tpersistence.records_to_standard_forest([chain])


def test_directory_checks(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_model(str(tmp_path / "missing"), device="cpu")
    unsealed = tmp_path / "unsealed"
    shutil.copytree(FIXTURE, unsealed)
    (unsealed / "data" / "_SUCCESS").unlink()
    with pytest.raises(ValueError, match="not a sealed model directory"):
        load_model(str(unsealed), device="cpu")
    assert load_model(str(unsealed), device="cpu", require_success=False).forest.num_trees == 100
    meta = unsealed / "metadata" / "part-00000"
    doc = json.loads(meta.read_text())
    doc["class"] = jpersistence.EXTENDED_MODEL_CLASS
    meta.write_text(json.dumps(doc) + "\n")
    jmanifest.write(str(unsealed))  # sealed anew, as a save would
    # load_model follows the metadata class, so the extended loader finds a
    # standard node table; the standard loader refuses the class outright
    with pytest.raises(ValueError, match="does not match the metadata class"):
        load_model(str(unsealed), device="cpu", require_success=False)
    with pytest.raises(ValueError, match="metadata class mismatch"):
        IsolationForestModel.load(str(unsealed), device="cpu", require_success=False)
    doc["class"] = "com.example.NotAnIsolationForest"
    meta.write_text(json.dumps(doc) + "\n")
    jmanifest.write(str(unsealed))
    with pytest.raises(ValueError, match="metadata class mismatch"):
        load_model(str(unsealed), device="cpu", require_success=False)


def test_legacy_metadata_without_width(tmp_path):
    legacy = tmp_path / "legacy"
    shutil.copytree(FIXTURE, legacy)
    meta = legacy / "metadata" / "part-00000"
    doc = json.loads(meta.read_text())
    del doc["totalNumFeatures"]
    meta.write_text(json.dumps(doc) + "\n")
    jmanifest.write(str(legacy))  # sealed anew, as a save would
    assert load_model(str(legacy), device="cpu").total_num_features == -1
