"""The port's fit (``isoforest_tpu_torch/models/isolation_forest.py``,
``ops/quantile.py``, ``utils/params.py``) against the JAX package's, on the
CPU, with the same params, seed and rows.

Tolerances: forests node for node with no differing node (split features,
leaf counts, float32 thresholds bitwise). The port's Gumbel draws differ
from jax's by at most an ulp (``test_torch_prng.py``), so a node whose two
best draws tie within an ulp could flip its split feature and the subtree
under it; these seeded fits have none, and the card's fit of the full
fixture prints any it meets (``chip_smoke.py`` fit_parity). The threshold
is an exact quantile of each package's own scores, which differ by at most
2e-6 (their walks sum in other orders), so the two thresholds differ by at
most 2e-6 and the port's has rank error 0 on its own scores. The quantile
functions fed the same scores are bitwise equal.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from isoforest_tpu.models import IsolationForest as JaxEstimator
from isoforest_tpu.models.isolation_forest import _resolve_subsample_trees as jax_subsample
from isoforest_tpu.ops import quantile as jquantile
from isoforest_tpu.utils.params import IsolationForestParams as JaxParams
from isoforest_tpu.utils.params import resolve_params as jax_resolve
from isoforest_tpu_torch import IsolationForest
from isoforest_tpu_torch.models.isolation_forest import _resolve_subsample_trees
from isoforest_tpu_torch.ops import quantile
from isoforest_tpu_torch.utils.params import IsolationForestParams, resolve_params

PARAMS = dict(num_estimators=24, max_samples=64.0, contamination=0.05, random_seed=5)
FLT_MIN = float(np.finfo(np.float32).tiny)


def _forest_arrays(model):
    return [np.asarray(a.cpu().numpy() if isinstance(a, torch.Tensor) else a) for a in model.forest]


def _assert_same_forest(port, ref):
    f, t, n = _forest_arrays(port)
    jf, jt, jn = _forest_arrays(ref)
    np.testing.assert_array_equal(f, jf)
    np.testing.assert_array_equal(n, jn)
    np.testing.assert_array_equal(t.view(np.int32), jt.astype(np.float32).view(np.int32))


@pytest.fixture(scope="module")
def fits(mammography):
    X = mammography[0][:3000]
    ref = JaxEstimator(**PARAMS).fit(X, baseline=False)
    port = IsolationForest(**PARAMS, device="cpu").fit(X)
    return X, port, ref


def test_fit_grows_the_jax_packages_forest(fits):
    _, port, ref = fits
    assert port.forest.device.type == "cpu"
    assert (port.num_samples, port.num_features, port.total_num_features) == (
        ref.num_samples, ref.num_features, ref.total_num_features)
    _assert_same_forest(port, ref)


def test_fitted_threshold_within_the_rank_budget(fits):
    X, port, ref = fits
    scores = port.score(X)
    q = 1.0 - PARAMS["contamination"]
    assert quantile.quantile_rank_error(scores, port.outlier_score_threshold, q) == 0
    assert abs(port.outlier_score_threshold - ref.outlier_score_threshold) <= 2e-6
    ref_scores = np.asarray(ref.score(X))
    assert np.abs(scores.numpy() - ref_scores).max() <= 2e-6
    # fed the same scores, the two packages pick the same threshold
    assert quantile.contamination_threshold(torch.from_numpy(ref_scores), PARAMS["contamination"], 0.0) == (
        ref.outlier_score_threshold)


def test_fit_takes_a_dataframe_and_its_features_column(fits):
    import pandas as pd

    X, port, _ = fits
    frame = pd.DataFrame({"vec": list(X[:500]), "label": 0.0})
    got = IsolationForest(**PARAMS, features_col="vec", device="cpu").fit(frame)
    want = IsolationForest(**PARAMS, device="cpu").fit(X[:500])
    for a, b in zip(got.forest, want.forest):
        assert torch.equal(a, b)


def test_fit_on_nonfinite_rows_grows_the_jax_forest(mammography):
    """NaN and +-inf features propagate through the per-node min/max (both
    packages' scatter-min/max return NaN) and route left (``x >= t`` is
    false for NaN), so with ``nonfinite="allow"`` the forests still match."""
    X = mammography[0][:2000].copy()
    X[::17, 2] = np.nan
    X[5::23, 0] = np.inf
    X[7::29, 4] = -np.inf
    kw = dict(PARAMS, num_estimators=12)
    ref = JaxEstimator(**kw).fit(X, baseline=False, nonfinite="allow")
    port = IsolationForest(**kw, device="cpu").fit(X, nonfinite="allow")
    _assert_same_forest(port, ref)
    assert abs(port.outlier_score_threshold - ref.outlier_score_threshold) <= 2e-6
    with pytest.raises(ValueError, match="non-finite"):
        IsolationForest(**kw, device="cpu").fit(X, nonfinite="raise")


def test_fit_from_sample_is_bitwise(mammography):
    X = mammography[0][:800]
    rng = np.random.default_rng(3)
    bag = rng.integers(0, len(X), size=(PARAMS["num_estimators"], 64)).astype(np.int32)
    ref = JaxEstimator(**PARAMS).fit_from_sample(X, bag, baseline=False)
    port = IsolationForest(**PARAMS, device="cpu").fit_from_sample(X, bag)
    _assert_same_forest(port, ref)
    assert abs(port.outlier_score_threshold - ref.outlier_score_threshold) <= 2e-6
    assert port.num_samples == ref.num_samples == 64
    est = IsolationForest(**PARAMS, device="cpu")
    with pytest.raises(ValueError, match="trees but numEstimators"):
        est.fit_from_sample(X, bag[:3])
    with pytest.raises(ValueError, match="outside the sample matrix"):
        est.fit_from_sample(X[:10], bag)
    with pytest.raises(ValueError, match="absolute maxSamples"):
        est.set_max_samples(0.5).fit_from_sample(X, bag)


def test_fit_needs_a_device(monkeypatch, mammography):
    """No device named and no card: fit raises, it does not fall back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        IsolationForest(**PARAMS).fit(mammography[0][:100])


def _score_columns():
    rng = np.random.default_rng(11)
    uniform = rng.uniform(0.3, 0.8, 5000).astype(np.float32)
    heavy = np.concatenate([rng.standard_cauchy(3000), [1e21, -1e-29, 0.0]]).astype(np.float32)
    ties = np.repeat(rng.uniform(size=40), 100).astype(np.float32)
    flt_min = np.concatenate([np.full(30, FLT_MIN), np.zeros(20), rng.uniform(size=400),
                              [-FLT_MIN, 2 * FLT_MIN]]).astype(np.float32)
    return {"uniform": uniform, "heavy_tail": heavy, "ties": ties, "flt_min": flt_min}


@pytest.mark.parametrize("column", list(_score_columns()))
def test_quantiles_fed_the_same_scores_are_bitwise(column):
    """Including a column that holds FLT_MIN, where the JAX package's
    refined histogram is known to misrank (ROADMAP §C): the port gives
    the same answer, misranked or not."""
    s = _score_columns()[column]
    t = torch.from_numpy(s)
    for q in (0.0, 0.05, 0.5, 0.93, 0.98, 1.0):
        assert quantile.exact_quantile(t, q) == jquantile.exact_quantile(s, q)
        for eps in (1e-3, 0.01, 0.05):
            assert quantile.histogram_quantile(t, q, eps=eps) == jquantile.histogram_quantile(s, q, eps=eps)
    for contamination, error in ((0.02, 0.0), (0.07, 0.01), (0.3, 0.05)):
        for limit in (1 << 22, 100):  # 100: the histogram answers
            want = jquantile.contamination_threshold(s, contamination, error, exact_size_limit=limit)
            got = quantile.contamination_threshold(t, contamination, error, exact_size_limit=limit)
            assert got == want
            assert quantile.quantile_rank_error(t, got, 1.0 - contamination) == (
                jquantile.quantile_rank_error(s, want, 1.0 - contamination))
            assert quantile.observed_contamination(t, got) == pytest.approx(
                jquantile.observed_contamination(s, want), abs=1e-6)
    with pytest.raises(ValueError, match="not an element"):
        quantile.quantile_rank_error(t, 7.5, 0.5)


def test_subnormal_windows_flush_as_xla_does():
    """C5: once the refined window's edges turn subnormal, XLA:CPU's
    float32 steps flush them to zero; the port flushes too, and returns the
    reference's element (the parent returned 256.0 here)."""
    s = np.repeat(np.float32([256, 6.322705108303872e16, -0.9999899864196777, 256, -0.0, 3.721737767852442e16,
                              -0.0]), 3)
    q = 0.30528659477443704
    want = jquantile.histogram_quantile(s, q, eps=1e-3)
    got = quantile.histogram_quantile(torch.from_numpy(s), q, eps=1e-3)
    assert want == 0.0 and np.signbit(want)
    assert got == want and np.signbit(got)


def _property_draws(seed: int, count: int):
    """Columns shaped like ``tests/test_properties.py``'s quantile draws:
    finite float32 in [-1e30, 1e30] with ties, zeros of both signs, powers
    of two down to FLT_MIN and small integers, repeated 1-6 times, at a
    uniform q and one of its three error budgets; 60 scores each, so the
    JAX package compiles its steps once."""
    rng = np.random.default_rng(seed)
    for _ in range(count):
        dup = int(rng.choice([1, 2, 3, 4, 5, 6]))
        n = 60 // dup
        kind = rng.integers(0, 4, n)
        sign = rng.choice([-1.0, 1.0], n)
        pool = np.select([kind == 0, kind == 1, kind == 2],
                         [sign * 0.0, sign * 2.0 ** rng.integers(-126, 100, n), sign * rng.integers(0, 300, n)],
                         sign * 10.0 ** rng.uniform(-30, 30, n))
        data = np.clip(pool, -1e30, 1e30).astype(np.float32)
        yield np.repeat(data, dup), float(rng.uniform()), float(rng.choice([1e-3, 0.01, 0.05]))


def test_seeded_sweep_returns_the_references_element():
    """C5: 200 seeded draws; the port returns the reference's element on
    every one, including draws where the reference itself breaks the rank
    contract (the port copies it, it does not improve on it). Before the
    flush, 2 of these draws differed."""
    for s, q, eps in _property_draws(0, 200):
        want = jquantile.histogram_quantile(s, q, eps=eps)
        got = quantile.histogram_quantile(torch.from_numpy(s), q, eps=eps)
        assert got == want, (s.tolist(), q, eps)


@pytest.mark.parametrize("special", [np.nan, np.inf, -np.inf], ids=["nan", "inf", "neg_inf"])
@pytest.mark.parametrize("q", [0.1, 0.5, 0.95])
def test_nonfinite_columns_return_the_references_element(special, q):
    """C6: a NaN bin goes where XLA's float-to-int convert puts it (bin 0,
    measured on this host), where the parent's cast made it INT64_MIN and
    ``bincount`` raised. The answers break the contract (q = 0.95 of the
    +inf column gives 0.1); the port copies them."""
    from isoforest_tpu.ops.quantile import jnp

    assert int(jnp.asarray(np.float32(np.nan)).astype(jnp.int32)) == 0  # the rule the port writes out
    s = np.float32([0.1, 0.5, special, 0.7, 0.9])
    want = jquantile.histogram_quantile(s, q)
    got = quantile.histogram_quantile(torch.from_numpy(s), q)
    assert got == want or (np.isnan(got) and np.isnan(want))
    exact, exact_ref = quantile.exact_quantile(torch.from_numpy(s), q), jquantile.exact_quantile(s, q)
    assert exact == exact_ref or (np.isnan(exact) and np.isnan(exact_ref))


def test_zero_contamination_leaves_the_threshold_unset(mammography):
    model = IsolationForest(num_estimators=8, max_samples=32.0, device="cpu").fit(mammography[0][:500])
    assert model.outlier_score_threshold == -1.0
    assert not model.predict(model.score(mammography[0][:500])).any()


RESOLVE_CASES = [
    (dict(max_samples=256.0, max_features=3.0), 6, 10000),
    (dict(max_samples=0.5, max_features=0.5), 6, 1000),
    (dict(max_features=1.0), 9, 100),
    (dict(max_samples=5000.0), 3, 100),
    (dict(max_samples=0.001), 3, 1000),
    (dict(max_samples=1.5), 3, 1000),
    (dict(max_features=10.0), 6, 100),
    (dict(max_features=0.1), 6, 100),
    (dict(), 6, 0),
    (dict(), 0, 10),
]


@pytest.mark.parametrize("kw,features,rows", RESOLVE_CASES)
def test_resolve_params_matches_jax(kw, features, rows):
    """The cases of tests/test_utils.py::TestResolveParams, and the refusals."""
    try:
        want = jax_resolve(JaxParams(**kw), features, rows)
    except ValueError as exc:
        with pytest.raises(ValueError, match=str(exc).split("(")[0][:30]):
            resolve_params(IsolationForestParams(**kw), features, rows)
        return
    got = resolve_params(IsolationForestParams(**kw), features, rows)
    assert (got.num_samples, got.num_features, got.total_num_samples, got.total_num_features) == (
        want.num_samples, want.num_features, want.total_num_samples, want.total_num_features)


@pytest.mark.parametrize("value", [1, 10, 100, 0.5, 1.0, 0.004, 0, 101, 1.5, True, "3", None])
def test_subsample_trees_matches_jax(value):
    try:
        want = jax_subsample(value, 100)
    except ValueError:
        with pytest.raises(ValueError):
            _resolve_subsample_trees(value, 100)
        return
    assert _resolve_subsample_trees(value, 100) == want


def test_subsample_trees_fit(mammography):
    X = mammography[0][:600]
    model = IsolationForest(num_estimators=20, max_samples=32.0, device="cpu").fit(X, subsample_trees=0.25)
    assert model.forest.num_trees == 5 and model.params.num_estimators == 5
    full = IsolationForest(num_estimators=5, max_samples=32.0, device="cpu").fit(X)
    for a, b in zip(model.forest, full.forest):
        assert torch.equal(a, b)


def test_setters_replace_params_and_return_self():
    est = IsolationForest(device="cpu")
    ref = JaxEstimator()
    for name, value in [("num_estimators", 7), ("max_samples", 0.25), ("contamination", 0.1),
                        ("contamination_error", 0.01), ("max_features", 0.5), ("bootstrap", True),
                        ("random_seed", 9), ("features_col", "f"), ("prediction_col", "p"), ("score_col", "s")]:
        before = est.params
        assert getattr(est, f"set_{name}")(value) is est
        getattr(ref, f"set_{name}")(value)
        assert getattr(est.params, name) == value and getattr(before, name) != value
    assert est.params.to_param_map() == ref.params.to_param_map()
    assert IsolationForestParams().replace(num_estimators=3).num_estimators == 3
    with pytest.raises(ValueError, match="contamination"):
        est.set_contamination(0.6)
