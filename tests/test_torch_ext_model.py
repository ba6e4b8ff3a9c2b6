"""The port's EIF serving path as a whole, load -> score -> predict ->
transform, against the JAX package's ``ExtendedIsolationForestModel`` on
the committed JAX-written mammography EIF, on the CPU.

Each port strategy is held to its own counterpart: ``walk`` to the JAX
package's ``walk`` (the ``_extended_walk`` kernel in interpret mode) and
``dense`` to its ``pallas`` (``_extended_pallas_sparse``), atol 2e-6 on
scores (mean path lengths agree within 1e-5, and the score has a slope
below 0.1 in E[h] at c(256)). Against the JAX gather walk, ``dense``
agrees within 2e-6 too, while ``walk`` differs where a tie routes the
other way under the walk kernel's order, exactly where the JAX package's
own walk kernel differs (held to TestQuantizedTieRouting's bounds).
"""

from __future__ import annotations

import pathlib

import numpy as np
import pytest
import torch

from isoforest_tpu.models import ExtendedIsolationForestModel as JaxModel
from isoforest_tpu.ops.ext_growth import ExtendedForest as JaxForest
from isoforest_tpu_torch import ExtendedIsolationForestModel, load_model, score_matrix
from isoforest_tpu_torch.io.interop import extended_forest_from_arrays, extended_model_from_arrays
from isoforest_tpu_torch.ops import dense
from isoforest_tpu_torch.testing import finite_rows, random_extended_forest

FIXTURE_DIR = pathlib.Path(__file__).parent / "resources" / "torch_port" / "mammography_eif"
FIXTURE = FIXTURE_DIR / "model"
ATOL = 2e-6
JAX_COUNTERPART = {"walk": "walk", "dense": "pallas"}


@pytest.fixture(scope="module")
def sliced(mammography):
    """16 trees of the fixture in both packages, and 2,048 rows."""
    full = JaxModel.load(str(FIXTURE))
    arrays = tuple(np.asarray(a)[:16] for a in full.forest)
    ref = JaxModel(
        forest=JaxForest(*arrays), params=full.params, num_samples=full.num_samples,
        num_features=full.num_features, extension_level=full.extension_level,
        total_num_features=full.total_num_features, outlier_score_threshold=full.outlier_score_threshold,
    )
    port = extended_model_from_arrays(
        *arrays, num_samples=full.num_samples, num_features=full.num_features,
        total_num_features=full.total_num_features, outlier_score_threshold=full.outlier_score_threshold,
        device="cpu",
    )
    return port, ref, np.ascontiguousarray(mammography[0][:2048])


@pytest.mark.parametrize("strategy", ["walk", "dense"])
def test_scores_match_their_jax_counterparts(sliced, strategy, auroc_fn, mammography):
    port, ref, X = sliced
    got = port.score(X, strategy=strategy)
    assert got.dtype == torch.float32 and got.device.type == "cpu" and got.shape == (len(X),)
    got = got.numpy()
    want = np.asarray(ref.score(X, strategy=JAX_COUNTERPART[strategy]))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    gather = np.asarray(ref.score(X, strategy="gather"))
    diff = np.abs(got - gather)
    y = mammography[1][: len(X)]
    assert diff.max() < 0.05 and (diff > 1e-5).mean() < 0.5
    assert abs(auroc_fn(got, y) - auroc_fn(gather, y)) < 1e-3 and abs(got.mean() - gather.mean()) < 1e-3
    if strategy == "dense":
        np.testing.assert_allclose(got, gather, rtol=0, atol=ATOL)


def test_predict_and_transform_match_jax_package(sliced):
    port, ref, X = sliced
    scores = port.score(X)  # auto: the walk
    want = np.asarray(ref.score(X, strategy="walk"))
    labels = port.predict(scores)
    assert labels.dtype == torch.float64
    away = np.abs(want - ref.outlier_score_threshold) > ATOL
    np.testing.assert_array_equal(labels.numpy()[away], ref.predict(want)[away])
    assert labels.sum() > 0
    out = port.transform(X)
    assert set(out) == {"outlierScore", "predictedLabel"}
    np.testing.assert_array_equal(out["outlierScore"].numpy(), scores.numpy().astype(np.float64))
    torch.testing.assert_close(out["predictedLabel"], labels, rtol=0, atol=0)


def test_full_fixture_walk_matches_committed_scores(mammography):
    """All 100 trees and 11,183 rows: the port's walk against the committed
    scores of the JAX walk kernel (what the card is held to), and its AUROC
    against the JAX gather scores'."""
    port = load_model(str(FIXTURE), device="cpu")
    assert isinstance(port, ExtendedIsolationForestModel)
    got = port.score(mammography[0], strategy="walk").numpy()
    np.testing.assert_allclose(got, np.load(FIXTURE_DIR / "jax_walk_scores.npy"), rtol=0, atol=ATOL)
    gather = np.load(FIXTURE_DIR / "jax_scores.npy")
    assert np.abs(got - gather).max() < 0.05


def test_model_from_jax_arrays_scores_like_jax_model(mammography):
    """The weight carry-across: the JAX EIF's arrays, as numpy, become the
    port's model and score alike (walk against walk)."""
    ref = JaxModel.load(str(FIXTURE))
    X = np.ascontiguousarray(mammography[0][:1024])
    port = extended_model_from_arrays(
        *(np.asarray(a) for a in ref.forest), num_samples=ref.num_samples, num_features=ref.num_features,
        extension_level=ref.extension_level, device="cpu",
    )
    assert port.extension_level == 5 and port.forest.k == 6
    np.testing.assert_allclose(
        port.score(X).numpy(), np.load(FIXTURE_DIR / "jax_walk_scores.npy")[:1024], rtol=0, atol=ATOL
    )


def test_chunking_is_bitwise_neutral(sliced):
    port, _, X = sliced
    for strategy in ("walk", "dense"):
        torch.testing.assert_close(
            port.score(X[:1500], strategy=strategy, chunk_size=377),
            port.score(X[:1500], strategy=strategy), rtol=0, atol=0,
        )
    assert port.score(X[:0]).shape == (0,)


def test_width_checks(sliced):
    port, _, X = sliced
    with pytest.raises(ValueError, match="trained on 6"):
        port.score(X[:10, :5])
    with pytest.raises(ValueError, match="splits on feature index 5"):
        score_matrix(port.forest, X[:10, :5], 256, device="cpu")
    with pytest.raises(ValueError, match="2-D"):
        port.score(X[0])


def test_unknown_strategy_raises(sliced):
    with pytest.raises(ValueError, match="unknown scoring strategy"):
        sliced[0].score(sliced[2][:4], strategy="pallas")


def test_dense_height_fence_and_walk_serves_it():
    """Above the dense kernels' height fence ``dense`` raises a ValueError
    naming it, and ``walk`` serves the forest."""
    rng = np.random.default_rng(12)
    arrays = random_extended_forest(rng, 2, dense.DENSE_MAX_HEIGHT + 1, 4, 2, split_p=0.3)
    model = extended_model_from_arrays(*arrays, num_samples=4096, num_features=4, device="cpu")
    X = finite_rows(rng, 50, 4)
    with pytest.raises(ValueError, match="DENSE_MAX_HEIGHT=10"):
        model.score(X, strategy="dense")
    assert torch.isfinite(model.score(X, strategy="walk")).all()


def test_nonfinite_policy(sliced):
    port, _, X = sliced
    X = X[:50].copy()
    X[3, 2] = np.nan
    with pytest.raises(ValueError, match="nonfinite='raise'"):
        port.score(X, nonfinite="raise")
    for strategy in ("walk", "dense"):
        assert torch.isfinite(port.score(X, nonfinite="allow", strategy=strategy)).all()


def test_forest_shape_checks():
    idx = np.full((2, 3, 2), -1, np.int32)
    with pytest.raises(ValueError, match=r"2\^\(h\+1\)-1"):
        extended_forest_from_arrays(idx[:, :2], np.zeros((2, 2, 2)), np.zeros((2, 2)), np.ones((2, 2)), device="cpu")
    with pytest.raises(ValueError, match="share one"):
        extended_forest_from_arrays(idx, np.zeros((2, 3, 1)), np.zeros((2, 3)), np.ones((2, 3)), device="cpu")
    with pytest.raises(ValueError, match="numSamples"):
        extended_model_from_arrays(idx, np.zeros((2, 3, 2)), np.zeros((2, 3)), np.ones((2, 3)),
                                   num_samples=1, num_features=1, device="cpu")


def test_no_device_and_no_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_model(str(FIXTURE))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ExtendedIsolationForestModel.load(str(FIXTURE), device="cuda")
