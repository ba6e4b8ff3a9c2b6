"""The port's EIF fit (``isoforest_tpu_torch/models/extended.py``, through
``ops/ext_growth.py``) against the JAX package's, on the CPU, with the same
params, seed and rows.

Tolerances: forests node for node and bit for bit (hyperplane indices,
float32 weights and offsets, leaf counts): ``normal`` is jax's bit for bit
and growth's sums keep XLA:CPU's order (``test_torch_ext_growth.py``); only
a Gumbel near-tie within an ulp of torch's ``log`` could flip a subspace,
and these fits have none. The threshold is an exact quantile of each
package's own training scores: the port's ``auto`` is the walk kernel's
order, the JAX package's on this CPU the gather walk, which routes some
tied rows otherwise (ROADMAP §C, EIF tie routing; on an 800-row sample the
two thresholds differ by 0.0023). So the port's threshold is held within
2e-6 of the JAX package's quantile of its own walk kernel's scores
(interpret mode; the two walks' scores differ by an ulp where torch's and
XLA's ``log`` of ``c(n)`` do), at rank error 0 on the port's scores, and
bit for bit to the quantile of the same scores fed in.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import auroc
from isoforest_tpu.data import sinusoid, two_blobs
from isoforest_tpu.models.extended import ExtendedIsolationForest as JaxEstimator
from isoforest_tpu_torch import ExtendedIsolationForest, ExtendedIsolationForestModel, load_model
from isoforest_tpu_torch.ops import quantile
from isoforest_tpu_torch.ops.ext_growth import ExtendedForest
from isoforest_tpu_torch.testing import torch_threads
from quality_bands import check as band

PARAMS = dict(num_estimators=24, max_samples=64.0, contamination=0.05, random_seed=5)
EIF_FIXTURE = Path(__file__).parent / "resources" / "torch_port" / "mammography_eif"
FIXTURE_THRESHOLD = 0.6251140236854553


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def _jax_walk_threshold(ref, X, contamination: float) -> float:
    """The JAX package's contamination threshold of its walk kernel's scores
    (``_extended_walk`` in interpret mode), the order the port's ``auto`` takes."""
    import jax.numpy as jnp

    from isoforest_tpu.ops.pallas_walk import path_lengths_walk
    from isoforest_tpu.ops.quantile import contamination_threshold
    from isoforest_tpu.utils.math import score_from_path_length

    scores = score_from_path_length(path_lengths_walk(ref.forest, jnp.asarray(X), interpret=True), ref.num_samples)
    return float(contamination_threshold(scores, contamination, 0.0))


def _assert_same_forest(port, ref) -> None:
    assert isinstance(port.forest, ExtendedForest)
    for name in ("indices", "weights", "offset", "num_instances"):
        got, want = getattr(port.forest, name).cpu().numpy(), np.asarray(getattr(ref.forest, name))
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32), err_msg=name)


@pytest.fixture(scope="module")
def fits(mammography):
    X = mammography[0][:3000]
    ref = JaxEstimator(**PARAMS).fit(X, baseline=False)
    port = ExtendedIsolationForest(**PARAMS, device="cpu").fit(X)
    return X, port, ref


@pytest.fixture(scope="module")
def fixture_fit(mammography):
    """The committed fixture's own fit, by the port on the CPU."""
    return ExtendedIsolationForest(contamination=0.02, random_seed=1, device="cpu").fit(mammography[0])


def test_fit_grows_the_jax_packages_forest(fits):
    _, port, ref = fits
    assert isinstance(port, ExtendedIsolationForestModel) and port.forest.device.type == "cpu"
    assert (port.num_samples, port.num_features, port.total_num_features, port.extension_level) == (
        ref.num_samples, ref.num_features, ref.total_num_features, ref.extension_level) == (64, 6, 6, 5)
    assert port.params.extension_level is None  # the estimator's params stay unresolved
    _assert_same_forest(port, ref)


def test_fitted_threshold_within_the_rank_budget(fits):
    X, port, ref = fits
    scores = port.score(X)
    assert quantile.quantile_rank_error(scores, port.outlier_score_threshold, 1.0 - PARAMS["contamination"]) == 0
    assert abs(port.outlier_score_threshold - _jax_walk_threshold(ref, X, PARAMS["contamination"])) <= 2e-6
    ref_scores = np.asarray(ref.score(X))
    assert quantile.contamination_threshold(torch.from_numpy(ref_scores), PARAMS["contamination"], 0.0) == (
        ref.outlier_score_threshold)


def test_the_fixtures_fit_node_for_node(fixture_fit, mammography):
    """``ExtendedIsolationForest(contamination=0.02, random_seed=1).fit`` of
    mammography is the committed JAX-written fixture node for node (0
    differing nodes), its threshold within 2e-6 of the fixture's, its walk
    scores within 2e-6 of the JAX walk kernel's, and its AUPRC in the JAX
    package's band."""
    X, y = mammography
    fixture = load_model(str(EIF_FIXTURE / "model"), device="cpu")
    _assert_same_forest(fixture_fit, fixture)
    assert abs(fixture_fit.outlier_score_threshold - FIXTURE_THRESHOLD) <= 2e-6
    scores = fixture_fit.score(X).numpy()
    assert np.abs(scores - np.load(EIF_FIXTURE / "jax_walk_scores.npy")).max() <= 2e-6
    gather = np.load(EIF_FIXTURE / "jax_scores.npy")
    assert abs(auroc(scores, y) - auroc(gather, y)) <= 1e-3
    order = np.argsort(-scores, kind="stable")
    hits = y[order]
    band("mammography_auprc_eif", float((np.cumsum(hits) / np.arange(1, len(y) + 1))[hits == 1].mean()))


def test_extension_level(mammography):
    X = mammography[0][:1000]
    est = ExtendedIsolationForest(**PARAMS, device="cpu")
    assert est.set_extension_level(2) is est and est.params.extension_level == 2
    model = est.fit(X)
    assert model.extension_level == 2 and model.forest.k == 3
    ref = JaxEstimator(**PARAMS, extension_level=2).fit(X, baseline=False)
    _assert_same_forest(model, ref)
    with pytest.raises(ValueError, match="exceeds maximum"):
        est.set_extension_level(6).fit(X)
    half = ExtendedIsolationForest(**PARAMS, max_features=0.5, device="cpu").fit(X)
    assert (half.num_features, half.extension_level, half.forest.k) == (3, 2, 3)


def test_fit_from_sample_is_bitwise(mammography):
    X = mammography[0][:800]
    bag = np.random.default_rng(3).integers(0, len(X), size=(PARAMS["num_estimators"], 64)).astype(np.int32)
    ref = JaxEstimator(**PARAMS).fit_from_sample(X, bag, baseline=False)
    port = ExtendedIsolationForest(**PARAMS, device="cpu").fit_from_sample(X, bag)
    _assert_same_forest(port, ref)
    assert abs(port.outlier_score_threshold - _jax_walk_threshold(ref, X, PARAMS["contamination"])) <= 2e-6
    with pytest.raises(ValueError, match="trees but numEstimators"):
        ExtendedIsolationForest(**PARAMS, device="cpu").fit_from_sample(X, bag[:3])


def test_fit_needs_a_device(monkeypatch, mammography):
    """No device named and no card: fit raises, it does not fall back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ExtendedIsolationForest(**PARAMS).fit(mammography[0][:100])


def test_subsample_trees_and_zero_contamination(mammography):
    X = mammography[0][:1000]
    model = ExtendedIsolationForest(**dict(PARAMS, contamination=0.0), device="cpu").fit(X, subsample_trees=0.5)
    assert model.forest.num_trees == 12 and model.params.num_estimators == 12
    assert model.outlier_score_threshold == -1.0


@pytest.mark.parametrize("name,make", [("sinusoid_eif", sinusoid), ("two_blobs_eif", two_blobs)])
def test_quality_bands(name, make):
    """The JAX package's EIF gates (tests/test_quality_gates.py) on the
    port's CPU fit: 100 trees, seed 1, 6,000 rows."""
    X, y = make(n=6000)
    model = ExtendedIsolationForest(num_estimators=100, random_seed=1, device="cpu").fit(X)
    band(name, auroc(model.score(X).numpy(), y))
