"""The port's scoring path as a whole, load -> score -> predict ->
transform, against the JAX package's model on the committed JAX-written
mammography fixture, on the CPU.

Tolerance: atol 2e-6 on scores. Mean path lengths agree within 1e-5 (see
``test_torch_walk.py``) and the score ``2^(-E[h]/c(n))`` has a slope below
0.1 in ``E[h]`` at ``c(256)``.
"""

from __future__ import annotations

import pathlib

import numpy as np
import pytest
import torch

from isoforest_tpu.models import IsolationForestModel as JaxModel
from isoforest_tpu_torch import IsolationForestModel, load_model, score_matrix
from isoforest_tpu_torch.io.interop import forest_from_arrays, model_from_arrays

FIXTURE_DIR = pathlib.Path(__file__).parent / "resources" / "torch_port" / "mammography_std"
FIXTURE = FIXTURE_DIR / "model"
ATOL = 2e-6


@pytest.fixture(scope="module")
def models():
    return load_model(str(FIXTURE), device="cpu"), JaxModel.load(str(FIXTURE))


@pytest.fixture(scope="module")
def jax_gather_scores(models, mammography):
    return np.asarray(models[1].score(mammography[0], strategy="gather"))


@pytest.mark.parametrize("strategy", ["auto", "walk", "dense"])
def test_scores_match_jax_package(models, mammography, jax_gather_scores, strategy, auroc_fn):
    port, ref = models
    X, y = mammography
    got = port.score(X, strategy=strategy)
    assert got.dtype == torch.float32 and got.device.type == "cpu" and got.shape == (len(X),)
    got = got.numpy()
    np.testing.assert_allclose(got, jax_gather_scores, rtol=0, atol=ATOL)
    # the committed scores are what chip_smoke.py holds the card to
    np.testing.assert_allclose(got, np.load(FIXTURE_DIR / "jax_scores.npy"), rtol=0, atol=ATOL)
    assert 0.84 <= auroc_fn(got, y) <= 0.90


def test_predict_and_transform_match_jax_package(models, mammography, jax_gather_scores):
    port, ref = models
    X = mammography[0]
    scores = port.score(X)
    labels = port.predict(scores)
    assert labels.dtype == torch.float64
    want = ref.predict(jax_gather_scores)
    away = np.abs(jax_gather_scores - ref.outlier_score_threshold) > ATOL
    np.testing.assert_array_equal(labels.numpy()[away], want[away])
    out = port.transform(X)
    assert set(out) == {"outlierScore", "predictedLabel"}
    assert out["outlierScore"].dtype == torch.float64
    np.testing.assert_array_equal(out["outlierScore"].numpy(), scores.numpy().astype(np.float64))
    torch.testing.assert_close(out["predictedLabel"], labels, rtol=0, atol=0)


def test_unset_threshold_labels_nothing(models):
    port = model_from_arrays(*models[0].forest, num_samples=256, num_features=6, device="cpu")
    assert port.outlier_score_threshold == -1.0
    assert (port.predict(torch.ones(5)) == 0).all()
    with pytest.raises(ValueError, match=r"in \[0, 1\]"):
        port.set_outlier_score_threshold(1.5)


def test_model_from_jax_arrays_scores_like_jax_model(models, mammography):
    """The weight carry-across: the JAX forest's arrays, as numpy, become
    the port's model and score alike."""
    ref = models[1]
    X = np.ascontiguousarray(mammography[0][:1500])
    port = model_from_arrays(
        *(np.asarray(a) for a in ref.forest), num_samples=ref.num_samples,
        num_features=ref.num_features, total_num_features=ref.total_num_features,
        outlier_score_threshold=ref.outlier_score_threshold, device="cpu",
    )
    np.testing.assert_allclose(port.score(X).numpy(), np.asarray(ref.score(X, strategy="gather")), rtol=0, atol=ATOL)


def test_chunking_is_bitwise_neutral(models, mammography):
    port = models[0]
    X = mammography[0][:3000]
    whole = port.score(X)
    for strategy in ("walk", "dense"):
        torch.testing.assert_close(port.score(X, strategy=strategy, chunk_size=777),
                                   port.score(X, strategy=strategy), rtol=0, atol=0)
    assert port.score(X[:0]).shape == (0,)
    assert whole.shape == (3000,)


def test_width_mismatch_raises(models, mammography):
    port = models[0]
    with pytest.raises(ValueError, match="trained on 6"):
        port.score(mammography[0][:10, :5])
    # a bare score_matrix call with no expected width still refuses rows
    # narrower than the forest's highest split feature
    with pytest.raises(ValueError, match="splits on feature index 5"):
        score_matrix(port.forest, mammography[0][:10, :5], 256, device="cpu")
    with pytest.raises(ValueError, match="2-D"):
        port.score(mammography[0][0])


def test_nonfinite_policy(models, mammography):
    port = models[0]
    X = mammography[0][:50].copy()
    X[3, 2] = np.nan
    with pytest.raises(ValueError, match="nonfinite='raise'"):
        port.score(X, nonfinite="raise")
    scores = port.score(X, nonfinite="allow")
    assert torch.isfinite(scores).all()


def test_unknown_strategy_raises(models, mammography):
    with pytest.raises(ValueError, match="unknown scoring strategy"):
        models[0].score(mammography[0][:4], strategy="gather")


def test_no_device_and_no_card_raises(monkeypatch, mammography):
    """Entry points default to the card and never drop to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_model(str(FIXTURE))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        IsolationForestModel.load(str(FIXTURE), device="cuda")
    f = np.full((1, 1), -1, np.int32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        forest_from_arrays(f, np.zeros((1, 1), np.float32), np.ones((1, 1), np.int32))
    forest = forest_from_arrays(f, np.zeros((1, 1), np.float32), np.ones((1, 1), np.int32), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        score_matrix(forest, mammography[0][:4], 256)


def test_forest_shape_checks():
    f = np.full((2, 3), -1, np.int32)
    with pytest.raises(ValueError, match=r"2\^\(h\+1\)-1"):
        forest_from_arrays(f[:, :2], np.zeros((2, 2)), np.ones((2, 2)), device="cpu")
    with pytest.raises(ValueError, match="share one"):
        forest_from_arrays(f, np.zeros((2, 3)), np.ones((2, 1)), device="cpu")
    with pytest.raises(ValueError, match="numSamples"):
        model_from_arrays(f, np.zeros((2, 3)), np.ones((2, 3)), num_samples=1, num_features=1, device="cpu")
