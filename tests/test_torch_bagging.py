"""The port's bags and feature subsets (``isoforest_tpu_torch/ops/bagging.py``)
against the JAX package's (``isoforest_tpu/ops/bagging.py``), on the CPU:
bitwise equal in every branch of the sampler dispatch. The top-k and the
second Floyd branch are reached with small thresholds passed in, as the
JAX package's jitted sampler takes them."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from isoforest_tpu.ops import bagging as jbag
from isoforest_tpu_torch.ops import bagging, prng


def _keys(seed: int):
    return jax.random.PRNGKey(np.uint32(seed)), prng.PRNGKey(seed)


@pytest.mark.parametrize("num_trees", [1, 5, 100])
def test_per_tree_keys(num_trees):
    jk, pk = _keys(9)
    np.testing.assert_array_equal(bagging.per_tree_keys(pk, num_trees).numpy(),
                                  np.asarray(jbag.per_tree_keys(jk, num_trees)))


# (rows, samples, trees, bootstrap, permutation limit, Floyd limit)
BRANCHES = {
    "bootstrap": (1000, 64, 8, True, jbag._PERMUTATION_MAX_ELEMS, jbag._FLOYD_MAX_SAMPLES),
    "floyd": (1000, 64, 8, False, jbag._PERMUTATION_MAX_ELEMS, jbag._FLOYD_MAX_SAMPLES),
    "permutation": (300, 256, 4, False, jbag._PERMUTATION_MAX_ELEMS, jbag._FLOYD_MAX_SAMPLES),
    "floyd_past_permutation": (300, 256, 4, False, 100, jbag._FLOYD_MAX_SAMPLES),
    "topk": (500, 64, 6, False, 100, 16),
}


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_bagged_indices_every_branch(branch):
    n, s, t, bootstrap, perm_max, floyd_max = BRANCHES[branch]
    for seed in (0, 2**31 + 1):
        jk, pk = _keys(seed)
        want = np.asarray(jbag._bagged_indices_jit(jk, n, s, t, bootstrap, perm_max, floyd_max))
        got = bagging._bagged_indices(pk, n, s, t, bootstrap, perm_max, floyd_max)
        assert got.dtype == torch.int32 and got.shape == (t, s)
        np.testing.assert_array_equal(got.numpy(), want)
        if (perm_max, floyd_max) == (bagging.PERMUTATION_MAX_ELEMS, bagging.FLOYD_MAX_SAMPLES):
            np.testing.assert_array_equal(bagging.bagged_indices(pk, n, s, t, bootstrap).numpy(), want)
        if not bootstrap:
            assert (np.diff(np.sort(want, axis=1), axis=1) > 0).all()


def test_default_thresholds_are_the_jax_packages():
    assert bagging.PERMUTATION_MAX_ELEMS == jbag._PERMUTATION_MAX_ELEMS
    assert bagging.FLOYD_MAX_SAMPLES == jbag._FLOYD_MAX_SAMPLES
    jk, pk = _keys(4)
    np.testing.assert_array_equal(bagging.bagged_indices(pk, 11_183, 256, 10, False).numpy(),
                                  np.asarray(jbag.bagged_indices(jk, 11_183, 256, 10, False)))


def test_too_many_distinct_rows_refused():
    jk, pk = _keys(0)
    with pytest.raises(ValueError, match="without replacement"):
        jbag.bagged_indices(jk, 10, 11, 2, False)
    with pytest.raises(ValueError, match="without replacement"):
        bagging.bagged_indices(pk, 10, 11, 2, False)
    assert bagging.bagged_indices(pk, 10, 11, 2, True).shape == (2, 11)


@pytest.mark.parametrize("total,num,trees", [(6, 6, 10), (6, 3, 10), (274, 137, 4), (1, 1, 3), (9, 4, 100)])
def test_feature_subsets(total, num, trees):
    jk, pk = _keys(7)
    got = bagging.feature_subsets(pk, total, num, trees)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jbag.feature_subsets(jk, total, num, trees)))


def test_gather_tree_data():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(50, 7)).astype(np.float32)
    bag = rng.integers(0, 50, size=(3, 9)).astype(np.int32)
    fidx = np.sort(rng.permuted(np.tile(np.arange(7), (3, 1)), axis=1)[:, :4], axis=1).astype(np.int32)
    want = np.asarray(jbag.gather_tree_data(X, bag, fidx))
    got = bagging.gather_tree_data(torch.from_numpy(X), torch.from_numpy(bag), torch.from_numpy(fidx))
    np.testing.assert_array_equal(got.numpy(), want)
