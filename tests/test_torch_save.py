"""The port's save side and load-side checks (``isoforest_tpu_torch/io/persistence.py``,
``io/avro.py``, ``resilience/manifest.py``) and its DataFrame surface
(``utils/validation.py::extract_features``), against the JAX package, on the CPU.

A model the port fits and saves loads in the JAX package and scores within
2e-6 there (the two walks sum in other orders), with the same threshold and
paramMap. A directory that fails its manifest is refused (fault C2 of
ROADMAP §C), and ``transform`` takes and returns a DataFrame (fault C1).
An extended (EIF) model, loaded or fitted, saves in the reference's
extended layout and loads in the JAX package with the same arrays and
scores (fault C3: it was saved through the standard writer and failed).
"""

from __future__ import annotations

import json
import logging
import os
import pathlib
import shutil

import numpy as np
import pandas as pd
import pytest
import torch

from isoforest_tpu.io import avro as javro
from isoforest_tpu.io import persistence as jpersistence
from isoforest_tpu.models import IsolationForest as JaxEstimator
from isoforest_tpu.models import IsolationForestModel as JaxModel
from isoforest_tpu.models.extended import ExtendedIsolationForest as JaxExtendedEstimator
from isoforest_tpu.models.extended import ExtendedIsolationForestModel as JaxExtendedModel
from isoforest_tpu.ops.tree_growth import StandardForest as JaxForest
from isoforest_tpu.resilience import manifest as jmanifest
from isoforest_tpu_torch import (
    ExtendedIsolationForest,
    ExtendedIsolationForestModel,
    IsolationForest,
    IsolationForestModel,
    load_model,
)
from isoforest_tpu_torch.io import avro, persistence
from isoforest_tpu_torch.resilience import manifest
from isoforest_tpu_torch.testing import random_extended_forest, random_heap_forest, torch_threads

FIXTURE = pathlib.Path(__file__).parent / "resources" / "torch_port" / "mammography_std" / "model"
EIF_FIXTURE = FIXTURE.parent.parent / "mammography_eif" / "model"
PARAMS = dict(num_estimators=16, max_samples=64.0, contamination=0.03, random_seed=2)


@pytest.fixture(scope="module")
def fitted(mammography):
    X = mammography[0][:2000]
    return X, IsolationForest(**PARAMS, device="cpu").fit(X)


def test_port_save_loads_in_the_jax_package(fitted, tmp_path):
    X, model = fitted
    model.save(str(tmp_path / "m"))
    assert sorted(os.listdir(tmp_path)) == ["m"]  # no temporary directory left
    assert manifest.verify(str(tmp_path / "m")) == [] and jmanifest.verify(str(tmp_path / "m")) == []
    ref = JaxModel.load(str(tmp_path / "m"))
    np.testing.assert_array_equal(np.asarray(ref.forest.feature), model.forest.feature.numpy())
    np.testing.assert_array_equal(np.asarray(ref.forest.threshold), model.forest.threshold.numpy())
    np.testing.assert_array_equal(np.asarray(ref.forest.num_instances), model.forest.num_instances.numpy())
    assert ref.outlier_score_threshold == model.outlier_score_threshold
    assert ref.params.to_param_map() == model.params.to_param_map() and ref.uid == model.uid
    assert (ref.num_samples, ref.num_features, ref.total_num_features) == (
        model.num_samples, model.num_features, model.total_num_features)
    got = model.score(X).numpy()
    assert np.abs(np.asarray(ref.score(X, strategy="gather")) - got).max() <= 2e-6


def test_save_load_round_trip_in_the_port(fitted, tmp_path):
    X, model = fitted
    model.save(str(tmp_path / "m"))
    back = IsolationForestModel.load(str(tmp_path / "m"), device="cpu", verify=True)
    for a, b in zip(back.forest, model.forest):
        assert torch.equal(a, b)
    assert back.outlier_score_threshold == model.outlier_score_threshold
    assert torch.equal(back.score(X), model.score(X))
    with pytest.raises(FileExistsError):
        model.save(str(tmp_path / "m"))
    model.save(str(tmp_path / "m"), overwrite=True)


def test_node_records_and_bytes_match_the_jax_package(tmp_path):
    rng = np.random.default_rng(4)
    feature, threshold, num_instances = random_heap_forest(rng, 4, 5, 7)
    for t in range(4):
        want = jpersistence.standard_tree_to_records(feature[t], threshold[t], num_instances[t])
        assert persistence.standard_tree_to_records(feature[t], threshold[t], num_instances[t]) == want
        for rec in want:
            row = {"treeID": t, "nodeData": rec}
            got_bytes, want_bytes = bytearray(), bytearray()
            avro.encode_value(persistence.STANDARD_SCHEMA, row, got_bytes)
            javro.encode_value(jpersistence.STANDARD_SCHEMA, row, want_bytes)
            assert got_bytes == want_bytes
    assert persistence.STANDARD_SCHEMA == jpersistence.STANDARD_SCHEMA
    records = [{"treeID": 0, "nodeData": r} for r in want] + [{"treeID": 1, "nodeData": None}]
    for codec in ("null", "deflate"):
        path = str(tmp_path / f"{codec}.avro")
        avro.write_container(path, persistence.STANDARD_SCHEMA, records, codec=codec, block_records=3)
        assert javro.read_container(path)[1] == records == avro.read_container(path)[1]
    for value in (0, 1, -1, 63, -64, 2**31 - 1, -(2**31), 2**40):
        assert avro.encode_long(value) == javro.encode_long(value)


def test_manifest_matches_the_jax_package(fitted, tmp_path):
    fitted[1].save(str(tmp_path / "m"))
    assert manifest.build(str(tmp_path / "m")) == jmanifest.build(str(tmp_path / "m"))
    assert manifest.build(str(FIXTURE)) == json.loads((FIXTURE / "_MANIFEST.json").read_text())


def test_failed_save_leaves_nothing(fitted, tmp_path, monkeypatch):
    def broken(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(avro, "write_container", broken)
    with pytest.raises(OSError, match="disk full"):
        fitted[1].save(str(tmp_path / "m"))
    assert os.listdir(tmp_path) == []


def test_partial_directory_is_refused_and_swept(fitted, tmp_path):
    model = fitted[1]
    model.save(str(tmp_path / "m"))
    partial = tmp_path / "m.__tmp-deadbeef0000"
    shutil.copytree(tmp_path / "m", partial)
    for load in (load_model, JaxModel.load):
        kwargs = {"device": "cpu"} if load is load_model else {}
        with pytest.raises(ValueError, match="partial write"):
            load(str(partial), **kwargs)
    model.save(str(tmp_path / "m"), overwrite=True)  # sweeps the leftover
    assert sorted(os.listdir(tmp_path)) == ["m"]


def test_edited_directory_fails_its_manifest(tmp_path):
    """C2: the committed model with its threshold edited on disk is refused
    by the port's load, as by the JAX package's; ``verify=False`` skips the
    check, and ``verify=True`` wants a manifest."""
    model_dir = tmp_path / "m"
    shutil.copytree(FIXTURE, model_dir)
    meta = model_dir / "metadata" / "part-00000"
    doc = json.loads(meta.read_text())
    doc["outlierScoreThreshold"] = 0.01
    meta.write_text(json.dumps(doc) + "\n")
    with pytest.raises(ValueError, match="failed manifest verification"):
        JaxModel.load(str(model_dir))
    with pytest.raises(ValueError, match="failed manifest verification.*size mismatch"):
        load_model(str(model_dir), device="cpu")
    assert load_model(str(model_dir), device="cpu", verify=False).outlier_score_threshold == 0.01
    (model_dir / manifest.MANIFEST_NAME).unlink()
    assert load_model(str(model_dir), device="cpu").outlier_score_threshold == 0.01  # legacy layout
    with pytest.raises(ValueError, match="verify=True"):
        load_model(str(model_dir), device="cpu", verify=True)
    with pytest.raises(ValueError, match="verify must be"):
        load_model(str(model_dir), device="cpu", verify="always")


def test_estimator_save_load_round_trip(tmp_path):
    est = IsolationForest(**PARAMS, device="cpu").set_bootstrap(True)
    est.save(str(tmp_path / "e"))
    back = IsolationForest.load(str(tmp_path / "e"), device="cpu")
    assert back.params == est.params and back.uid == est.uid
    ref = JaxEstimator.load(str(tmp_path / "e"))
    assert ref.params.to_param_map() == est.params.to_param_map()
    JaxEstimator(**PARAMS).save(str(tmp_path / "j"))
    assert IsolationForest.load(str(tmp_path / "j")).params.to_param_map() == (
        JaxEstimator(**PARAMS).params.to_param_map())
    with pytest.raises(ValueError, match="metadata class mismatch"):
        IsolationForest.load(str(FIXTURE))


def test_transform_takes_and_returns_a_dataframe(fitted):
    """C1: a frame in, the frame with both columns appended out."""
    X, model = fitted
    frame = pd.DataFrame({"features": list(X[:300]), "label": 1.0})
    out = model.transform(frame)
    assert isinstance(out, pd.DataFrame) and list(out.columns) == ["features", "label", "outlierScore",
                                                                     "predictedLabel"]
    scores = model.score(X[:300])
    np.testing.assert_array_equal(out["outlierScore"].to_numpy(), scores.double().numpy())
    np.testing.assert_array_equal(out["predictedLabel"].to_numpy(), model.predict(scores).numpy())
    assert "outlierScore" not in frame.columns
    assert torch.equal(model.score(frame), scores)
    with pytest.raises(ValueError, match="already exists"):
        model.transform(out)
    with pytest.raises(ValueError, match="not found"):
        model.transform(frame.rename(columns={"features": "x"}))
    with pytest.raises(ValueError, match="vector-valued"):
        model.transform(pd.DataFrame({"features": X[:5, 0]}))
    arrays = model.transform(X[:300])
    assert set(arrays) == {"outlierScore", "predictedLabel"}


def test_transform_matches_the_jax_package_on_the_fixture(mammography):
    X = mammography[0][:2000]
    frame = pd.DataFrame({"features": list(X)})
    got = load_model(str(FIXTURE), device="cpu").transform(frame)
    want = JaxModel.load(str(FIXTURE)).transform(frame)
    np.testing.assert_allclose(got["outlierScore"].to_numpy(), want["outlierScore"].to_numpy(), rtol=0, atol=2e-6)
    away = np.abs(want["outlierScore"].to_numpy() - 0.6111048460006714) > 2e-6
    np.testing.assert_array_equal(got["predictedLabel"].to_numpy()[away], want["predictedLabel"].to_numpy()[away])


def test_jax_written_forest_round_trips_through_the_port(tmp_path):
    """The port re-saves what the JAX package wrote, and the JAX package
    reads it back to the same arrays."""
    rng = np.random.default_rng(8)
    forest = JaxForest(*(np.asarray(a) for a in random_heap_forest(rng, 6, 6, 5)))
    ref = JaxModel(forest=forest, params=JaxEstimator(**PARAMS).params, num_samples=64, num_features=5,
                   total_num_features=5).set_outlier_score_threshold(0.6)
    ref.save(str(tmp_path / "a"))
    load_model(str(tmp_path / "a"), device="cpu").save(str(tmp_path / "b"))
    back = JaxModel.load(str(tmp_path / "b"))
    for name in ("feature", "threshold", "num_instances"):
        np.testing.assert_array_equal(np.asarray(getattr(back.forest, name)), np.asarray(getattr(forest, name)))
    assert back.outlier_score_threshold == 0.6


@pytest.fixture
def one_torch_thread():
    with torch_threads(1):
        yield


def _same_extended_arrays(jax_forest, forest) -> None:
    for name in ("indices", "weights", "offset", "num_instances"):
        want, got = np.asarray(getattr(jax_forest, name)), getattr(forest, name).numpy()
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32), err_msg=name)


def test_loaded_extended_model_saves_for_the_jax_package(mammography, tmp_path, one_torch_thread):
    """C3: the port saves the JAX-written EIF fixture it loaded; the JAX
    package loads that directory with the same arrays, threshold and
    extensionLevel, and its gather scores equal the fixture's committed
    ones; the port reloads it to equal walk scores."""
    X = mammography[0]
    model = load_model(str(EIF_FIXTURE), device="cpu")
    model.save(str(tmp_path / "m"))
    assert sorted(os.listdir(tmp_path)) == ["m"]
    assert jmanifest.verify(str(tmp_path / "m")) == []
    ref = JaxExtendedModel.load(str(tmp_path / "m"))
    _same_extended_arrays(ref.forest, model.forest)
    assert ref.outlier_score_threshold == model.outlier_score_threshold == 0.6251140236854553
    assert ref.extension_level == model.extension_level == 5 and ref.uid == model.uid
    assert ref.params.to_param_map() == model.params.to_param_map()
    want = np.load(EIF_FIXTURE.parent / "jax_scores.npy")
    assert np.abs(np.asarray(ref.score(X, strategy="gather")) - want).max() <= 2e-6
    back = load_model(str(tmp_path / "m"), device="cpu", verify=True)
    assert isinstance(back, ExtendedIsolationForestModel) and back.extension_level == 5
    for a, b in zip(back.forest, model.forest):
        assert torch.equal(a, b)
    assert torch.equal(back.score(X[:2000]), model.score(X[:2000]))


def test_fitted_extended_model_saves_for_the_jax_package(mammography, tmp_path, one_torch_thread):
    """A fitted EIF whose estimator left extensionLevel unset saves the
    resolved level in its paramMap; the JAX package loads the same arrays
    and scores them within 2e-6 of the port's own gather walk."""
    from isoforest_tpu_torch.ops.traversal import extended_path_lengths
    from isoforest_tpu_torch.utils.math import score_from_path_length

    X = mammography[0][:2000]
    model = ExtendedIsolationForest(**PARAMS, device="cpu").fit(X)
    assert model.params.extension_level is None
    model.save(str(tmp_path / "m"))
    meta = json.loads((tmp_path / "m" / "metadata" / "part-00000").read_text())
    assert meta["class"] == persistence.EXTENDED_MODEL_CLASS and meta["paramMap"]["extensionLevel"] == 5
    ref = JaxExtendedModel.load(str(tmp_path / "m"))
    _same_extended_arrays(ref.forest, model.forest)
    assert ref.outlier_score_threshold == model.outlier_score_threshold and ref.extension_level == 5
    gather = score_from_path_length(extended_path_lengths(model.forest, torch.from_numpy(X)), model.num_samples)
    assert np.abs(np.asarray(ref.score(X, strategy="gather")) - gather.numpy()).max() <= 2e-6


def test_extended_records_and_bytes_match_the_jax_package():
    rng = np.random.default_rng(5)
    arrays = random_extended_forest(rng, 4, 5, 9, 4, unused_p=0.3)
    assert persistence.EXTENDED_SCHEMA == jpersistence.EXTENDED_SCHEMA
    for t in range(4):
        tree = [a[t] for a in arrays]
        want = jpersistence.extended_tree_to_records(*tree)
        assert persistence.extended_tree_to_records(*tree) == want
        for rec in want:
            row = {"treeID": t, "extendedNodeData": rec}
            got_bytes, want_bytes = bytearray(), bytearray()
            avro.encode_value(persistence.EXTENDED_SCHEMA, row, got_bytes)
            javro.encode_value(jpersistence.EXTENDED_SCHEMA, row, want_bytes)
            assert got_bytes == want_bytes


def test_extended_estimator_save_load_round_trip(tmp_path):
    est = ExtendedIsolationForest(**PARAMS, device="cpu").set_extension_level(2)
    est.save(str(tmp_path / "e"))
    back = ExtendedIsolationForest.load(str(tmp_path / "e"), device="cpu")
    assert back.params == est.params and back.uid == est.uid and back.params.extension_level == 2
    ref = JaxExtendedEstimator.load(str(tmp_path / "e"))
    assert ref.params.to_param_map() == est.params.to_param_map()
    meta = json.loads((tmp_path / "e" / "metadata" / "part-00000").read_text())
    assert meta["class"] == persistence.EXTENDED_ESTIMATOR_CLASS == jpersistence.EXTENDED_ESTIMATOR_CLASS
    with pytest.raises(ValueError, match="metadata class mismatch"):
        IsolationForest.load(str(tmp_path / "e"))


# -- the scoringRepresentation extra (fault C7) ---------------------------------


def _metadata(path) -> dict:
    return json.loads((pathlib.Path(path) / "metadata" / "part-00000").read_text())


@pytest.mark.parametrize("fixture", [FIXTURE, EIF_FIXTURE], ids=["std", "eif"])
def test_q16_representation_round_trips_from_the_jax_package(fixture, tmp_path):
    """C7: a q16 model the JAX package saves loads as q16 in the port, and
    the port's save keeps it for the JAX package (the parent dropped it)."""
    ref = jpersistence.load_model(str(fixture)).set_scoring_representation("q16")
    ref.save(str(tmp_path / "jax"))
    port = load_model(str(tmp_path / "jax"), device="cpu")
    assert port.scoring_representation == "q16"
    port.save(str(tmp_path / "port"))
    assert _metadata(tmp_path / "port")["scoringRepresentation"] == "q16"
    assert jpersistence.load_model(str(tmp_path / "port")).scoring_representation == "q16"


@pytest.mark.parametrize("fixture", [FIXTURE, EIF_FIXTURE], ids=["std", "eif"])
def test_q16_representation_round_trips_from_the_port(fixture, tmp_path):
    port = load_model(str(fixture), device="cpu").set_scoring_representation("q16")
    port.save(str(tmp_path / "port"))
    ref = jpersistence.load_model(str(tmp_path / "port"))
    assert ref.scoring_representation == "q16"
    ref.save(str(tmp_path / "jax"))
    back = load_model(str(tmp_path / "jax"), device="cpu")
    assert back.scoring_representation == "q16"
    assert ("q16", torch.device("cpu")) in back._cache  # the plane is built at load


def test_default_f32_writes_no_extra(fitted, tmp_path):
    _, model = fitted
    model.save(str(tmp_path / "f"))
    assert "scoringRepresentation" not in _metadata(tmp_path / "f")
    assert load_model(str(tmp_path / "f"), device="cpu").scoring_representation == "f32"
    assert jpersistence.load_model(str(tmp_path / "f")).scoring_representation == "f32"


@pytest.mark.parametrize("value", ["f32", "q4"])
def test_a_written_f32_or_unknown_value_loads_as_f32(fitted, tmp_path, caplog, value):
    """An explicit "f32" loads silently; an unknown value logs a warning and
    stays "f32", scores unchanged (``tests/test_persistence.py``'s rule)."""
    X, model = fitted
    path = tmp_path / "u"
    model.save(str(path))
    meta = _metadata(path)
    meta["scoringRepresentation"] = value
    (path / "metadata" / "part-00000").write_text(json.dumps(meta))
    (path / "_MANIFEST.json").unlink()  # the edit invalidates the manifest
    with caplog.at_level(logging.WARNING, logger="isoforest_tpu_torch"):
        back = load_model(str(path), device="cpu")
    assert back.scoring_representation == "f32"
    warned = [r for r in caplog.records if "scoringRepresentation" in r.getMessage()]
    assert len(warned) == (value != "f32")
    assert jpersistence.load_model(str(path)).scoring_representation == "f32"
    np.testing.assert_array_equal(back.score(X[:64]).numpy(), model.score(X[:64]).numpy())


def test_q16_on_a_forest_outside_the_fences_loads_as_f32(tmp_path, caplog):
    """A q16 extra over a forest the plane cannot hold (edited on disk, or
    salvaged) is a preference the load drops, with a warning."""
    rng = np.random.default_rng(4)
    feature, threshold, num_instances = random_heap_forest(rng, trees=400, height=8, features=4, split_p=0.99)
    threshold = rng.normal(size=threshold.shape).astype(np.float32)  # > 65,535 distinct thresholds
    from isoforest_tpu_torch.io.interop import model_from_arrays

    model = model_from_arrays(feature, threshold, num_instances, num_samples=256, num_features=4,
                              total_num_features=4, device="cpu")
    model.scoring_representation = "q16"  # as an edited directory would carry it
    model.save(str(tmp_path / "m"))
    assert _metadata(tmp_path / "m")["scoringRepresentation"] == "q16"
    with caplog.at_level(logging.WARNING, logger="isoforest_tpu_torch"):
        back = load_model(str(tmp_path / "m"), device="cpu")
    assert back.scoring_representation == "f32"
    assert any("distinct thresholds" in r.getMessage() for r in caplog.records)
    assert jpersistence.load_model(str(tmp_path / "m")).scoring_representation == "f32"
