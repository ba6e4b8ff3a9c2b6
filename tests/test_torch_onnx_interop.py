"""A model directory written by the port, read by the reference's published
converter (the ``isolation-forest-onnx`` package), and its ONNX scored with
onnxruntime against the port's scorer: ``tests/test_reference_converter_interop.py``
on the port.

The reference converter reads exactly the metadata JSON and Avro node rows
a Spark save produces, so agreement shows that the port's save writes the
true reference layout. Neither the package nor onnxruntime is a dependency
of the port: these tests skip where they are missing, and fail instead
under ``INTEROP_REQUIRED=1``.
"""

import glob
import os

import numpy as np
import pytest
import torch

_required = os.environ.get("INTEROP_REQUIRED") == "1"
try:
    import onnxruntime
    from isolationforestonnx.isolation_forest_converter import (
        IsolationForestConverter,
    )
except ImportError as exc:
    if _required:
        raise ImportError(
            f"INTEROP_REQUIRED=1 but the reference toolchain is missing: {exc}"
        ) from exc
    pytest.skip(
        "reference pip package isolation-forest-onnx / onnxruntime not "
        "installed (CI-only gate)",
        allow_module_level=True,
    )

from isoforest_tpu_torch import IsolationForest  # noqa: E402


def _saved_paths(model_dir):
    """(avro_file, metadata_file) as Spark lays them out — the two paths the
    reference converter's constructor takes."""
    [avro] = glob.glob(os.path.join(model_dir, "data", "*.avro"))
    meta = os.path.join(model_dir, "metadata", "part-00000")
    assert os.path.exists(meta)
    return avro, meta


@pytest.fixture(scope="module")
def written_model(tmp_path_factory):
    """(model, X, converter, onnxruntime session) — the port-written
    directory converted once by the reference's converter."""
    rng = np.random.default_rng(5)
    X = np.vstack(
        [
            rng.normal(size=(4000, 6)),
            rng.normal(loc=4.0, size=(160, 6)),
        ]
    ).astype(np.float32)
    model = IsolationForest(
        num_estimators=50, max_samples=128.0, contamination=0.04, random_seed=7, device="cpu"
    ).fit(X)
    model_dir = str(tmp_path_factory.mktemp("interop") / "model")
    model.save(model_dir)
    converter = IsolationForestConverter(*_saved_paths(model_dir))
    sess = onnxruntime.InferenceSession(converter.convert().SerializeToString())
    return model, X, converter, sess


class TestReferenceConverterReadsOurWrites:
    def test_score_parity_via_reference_converter(self, written_model):
        model, X, _, sess = written_model
        scores, _ = sess.run(None, {"features": X})
        ours = model.score(X).numpy()
        assert np.abs(scores[:, 0] - ours).max() < 1e-5

    def test_label_parity_via_reference_converter(self, written_model):
        model, X, _, sess = written_model
        _, labels = sess.run(None, {"features": X})
        ours = model.predict(model.score(X)).numpy()
        assert (labels[:, 0] == ours).mean() == 1.0

    def test_convert_and_save_roundtrip(self, written_model, tmp_path):
        model, X, converter, _ = written_model
        out = str(tmp_path / "model.onnx")
        converter.convert_and_save(out)
        sess = onnxruntime.InferenceSession(out)
        scores, _ = sess.run(None, {"features": X[:64]})
        assert np.isfinite(scores).all()
        assert torch.isfinite(model.score(X[:64])).all()
