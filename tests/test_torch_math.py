"""The PyTorch port's numeric primitives, params and input checks against
the JAX package's (``isoforest_tpu/utils``), on the CPU."""

from __future__ import annotations

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isoforest_tpu.utils import math as jmath
from isoforest_tpu.utils import params as jparams
from isoforest_tpu.utils import validation as jvalidation
from isoforest_tpu_torch.utils import math as tmath
from isoforest_tpu_torch.utils import params as tparams
from isoforest_tpu_torch.utils import validation as tvalidation


def _ulp_distance(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance in float32 units in the last place (both inputs >= 0)."""
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


class TestAvgPathLength:
    def test_matches_jax(self, request):
        n = np.arange(0, 4097)
        got = tmath.avg_path_length(n).numpy()
        want = np.asarray(jmath.avg_path_length(n))
        assert got.dtype == np.float32 and got.shape == want.shape
        # The formula's one transcendental is the float32 log of n - 1, and
        # torch's and XLA's CPU log differ there by at most one ulp.
        m = n[2:].astype(np.float32) - np.float32(1.0)
        log_ulps = _ulp_distance(torch.log(torch.from_numpy(m)).numpy(), np.asarray(jnp.log(m)))
        assert log_ulps.max() <= 1, f"log differs by {log_ulps.max()} ulp at n={int(log_ulps.argmax()) + 2}"
        # c(n) = 2 * (log + gamma) - 2 * (n - 1) / n: the doubling and the
        # subtraction carry one ulp of log into at most four ulps of c(n).
        ulps = _ulp_distance(got, want)
        assert ulps.max() <= 4 * log_ulps.max(), f"c(n) differs by {ulps.max()} ulp at n={int(ulps.argmax())}"
        assert (ulps[2:][log_ulps == 0] == 0).all(), "c(n) differs where log agrees"
        request.node.user_properties += [
            ("c_n_bitwise_equal", bool((ulps == 0).all())),
            ("c_n_ulp_mismatches", int((ulps != 0).sum())),
            ("c_n_max_ulps", int(ulps.max())),
        ]

    @pytest.mark.parametrize(
        "n,expected",
        [(0, 0.0), (1, 0.0), (2, 0.15443134), (10, 3.7488806), (2**63 - 1, 86.49098)],
    )
    def test_golden_points(self, n, expected):
        assert float(tmath.avg_path_length(n)) == pytest.approx(expected, abs=2e-5)
        assert float(tmath.avg_path_length(n)) == pytest.approx(float(jmath.avg_path_length(n)), abs=1e-5)

    def test_returns_cpu_float32_for_any_input(self):
        out = tmath.avg_path_length(torch.tensor([2, 10], dtype=torch.int64))
        assert out.dtype == torch.float32 and out.device.type == "cpu"
        assert float(out[0]) == pytest.approx(0.15443134, abs=1e-6)


@pytest.mark.parametrize("n", [1, 2, 3, 16, 255, 256, 257, 1000, 1 << 20])
def test_heights_match_jax(n):
    assert tmath.height_limit(n) == jmath.height_limit(n)
    assert tmath.max_nodes_for(n) == jmath.max_nodes_for(n)
    m = jmath.max_nodes_for(n)
    assert tmath.height_of(m) == jmath.height_of(m)


def test_score_from_path_length_matches_jax():
    rng = np.random.default_rng(0)
    pl = rng.uniform(0.0, 20.0, 4096).astype(np.float32)
    for num_samples in (2, 64, 256, 100_000):
        got = tmath.score_from_path_length(torch.from_numpy(pl), num_samples).numpy()
        want = np.asarray(jmath.score_from_path_length(pl, num_samples))
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-7)


def test_leaf_value_table_matches_jax():
    rng = np.random.default_rng(1)
    ni = rng.integers(-1, 300, size=(5, 2**6 - 1)).astype(np.int32)
    got = tmath.leaf_value_table(torch.from_numpy(ni), 5).numpy()
    want = jmath.leaf_value_table(ni, 5)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert (got[ni < 0] == 0).all()


class TestParams:
    def test_defaults_and_param_map_match_jax(self):
        assert tparams.IsolationForestParams().to_param_map() == jparams.IsolationForestParams().to_param_map()

    def test_from_param_map_round_trip(self):
        pm = jparams.IsolationForestParams(contamination=0.02, random_seed=7, max_samples=128.0).to_param_map()
        pm["extensionLevel"] = 3  # unknown keys are ignored
        got = tparams.IsolationForestParams.from_param_map(pm)
        assert got.to_param_map() == jparams.IsolationForestParams.from_param_map(pm).to_param_map()

    @pytest.mark.parametrize(
        "kw",
        [{"num_estimators": 0}, {"max_samples": 0.0}, {"contamination": 0.6},
         {"contamination_error": 1.5}, {"max_features": 0.0}, {"bootstrap": 1}],
    )
    def test_validators_match_jax(self, kw):
        with pytest.raises(ValueError):
            jparams.IsolationForestParams(**kw)
        with pytest.raises(ValueError):
            tparams.IsolationForestParams(**kw)


class TestValidation:
    def test_width_check(self):
        assert tvalidation.UNKNOWN_TOTAL_NUM_FEATURES == jvalidation.UNKNOWN_TOTAL_NUM_FEATURES
        tvalidation.validate_feature_vector_size(5, tvalidation.UNKNOWN_TOTAL_NUM_FEATURES)
        tvalidation.validate_feature_vector_size(6, 6)
        with pytest.raises(ValueError, match="trained on 6"):
            tvalidation.validate_feature_vector_size(5, 6)

    def test_non_finite_policies(self, caplog):
        X = torch.tensor([[1.0, float("nan")], [float("inf"), 0.0]])
        tvalidation.check_non_finite(X, "allow")
        with pytest.raises(ValueError, match="2 non-finite"):
            tvalidation.check_non_finite(X, "raise")
        with caplog.at_level(logging.WARNING, logger="isoforest_tpu_torch"):
            tvalidation.check_non_finite(X, "warn")
        assert "non-finite" in caplog.text
        with pytest.raises(ValueError, match="nonfinite policy"):
            tvalidation.check_non_finite(X, "ignore")
        tvalidation.check_non_finite(torch.ones(3, 2), "raise")
