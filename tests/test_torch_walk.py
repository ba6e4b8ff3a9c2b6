"""The PyTorch port's O(h) walk (``ops/walk.py``, the plain version of
``csrc/walk.cu``) and gather walk against the JAX package's walk kernel
(``pallas_walk.path_lengths_walk`` in interpret mode) and gather walk, on
the CPU.

Tolerance: atol 1e-5 on mean path length. The leaf values hold a float32
``log`` (torch's and XLA's differ by up to an ulp), and the three paths sum
trees in different orders: the gather walk per 8-tree block, the walk
kernel over all trees, then divide by T.
"""

from __future__ import annotations

import pathlib

import numpy as np
import pytest
import torch

from isoforest_tpu.models import IsolationForestModel as JaxModel
from isoforest_tpu.ops.pallas_walk import path_lengths_walk as jax_walk
from isoforest_tpu.ops.traversal import standard_path_lengths as jax_gather
from isoforest_tpu.ops.tree_growth import StandardForest as JaxForest
from isoforest_tpu.utils.math import leaf_value_table as jax_leaf_values
from isoforest_tpu_torch.io.interop import forest_from_arrays
from isoforest_tpu_torch.ops import walk
from isoforest_tpu_torch.ops.traversal import standard_path_lengths
from isoforest_tpu_torch.testing import random_heap_forest, rows

RESOURCES = pathlib.Path(__file__).parent / "resources"
FIXTURE = RESOURCES / "torch_port" / "mammography_std" / "model"
ATOL = 1e-5


def _port_walk(arrays, X) -> np.ndarray:
    tables = walk.walk_tables(forest_from_arrays(*arrays, device="cpu"))
    return walk.path_lengths_walk(torch.from_numpy(X), tables).numpy()


@pytest.mark.parametrize("features,height,n", [(1, 6, 1025), (13, 5, 1023), (4, 3, 1)])
def test_walk_matches_jax_walk_kernel_and_gather(features, height, n):
    rng = np.random.default_rng(features * 100 + height)
    arrays = random_heap_forest(rng, trees=11, height=height, features=features)
    X = rows(rng, n, features)
    got = _port_walk(arrays, X)
    jf = JaxForest(*arrays)
    np.testing.assert_allclose(got, np.asarray(jax_walk(jf, X, interpret=True)), rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(jax_gather(jf, X)), rtol=0, atol=ATOL)


def test_fixture_slice_matches_jax_walk_kernel(mammography):
    """16 trees of the JAX-written mammography model, 2,048 rows."""
    X = np.ascontiguousarray(mammography[0][:2048])
    jm = JaxModel.load(str(FIXTURE))
    arrays = tuple(np.asarray(a)[:16] for a in jm.forest)
    got = _port_walk(arrays, X)
    jf = JaxForest(*arrays)
    np.testing.assert_allclose(got, np.asarray(jax_walk(jf, X, interpret=True)), rtol=0, atol=ATOL)
    port_gather = standard_path_lengths(forest_from_arrays(*arrays, device="cpu"), torch.from_numpy(X))
    np.testing.assert_allclose(port_gather.numpy(), np.asarray(jax_gather(jf, X)), rtol=0, atol=ATOL)


def test_gather_walk_matches_jax_gather_on_nonfinite_rows():
    rng = np.random.default_rng(11)
    arrays = random_heap_forest(rng, trees=9, height=6, features=5)
    X = rows(rng, 777, 5)
    got = standard_path_lengths(forest_from_arrays(*arrays, device="cpu"), torch.from_numpy(X))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_gather(JaxForest(*arrays), X)), rtol=0, atol=ATOL)
    # the plain walk sums in the kernel's order, the gather walk per block
    np.testing.assert_allclose(_port_walk(arrays, X), got.numpy(), rtol=0, atol=ATOL)


def test_walk_tables_sentinels():
    rng = np.random.default_rng(2)
    feature, threshold, num_instances = random_heap_forest(rng, trees=4, height=4, features=3)
    tables = walk.walk_tables(forest_from_arrays(feature, threshold, num_instances, device="cpu"))
    internal = feature >= 0
    thr = tables.threshold.numpy()
    assert np.isposinf(thr[~internal]).all()
    np.testing.assert_array_equal(thr[internal], threshold[internal])
    np.testing.assert_array_equal(tables.feature.numpy(), np.maximum(feature, 0))
    leaf = tables.leaf.numpy()
    assert (leaf[internal] == 0).all() and (leaf[(~internal) & (num_instances < 0)] == 0).all()
    np.testing.assert_allclose(leaf, jax_leaf_values(num_instances, 4), rtol=0, atol=1e-6)
    assert tables.height == 4 and tables.num_trees == 4


def test_root_leaf_tree_and_hole_chain():
    """A tree that is a root leaf of size 1 (leaf value 0) keeps walking the
    hole chain, even right on +inf rows, and adds exactly 0."""
    m = 2**3 - 1
    feature = np.full((1, m), -1, np.int32)
    num_instances = np.full((1, m), -1, np.int32)
    num_instances[0, 0] = 1
    X = np.array([[np.inf], [-1.0], [np.nan]], np.float32)
    assert (_port_walk((feature, np.zeros((1, m), np.float32), num_instances), X) == 0).all()


def test_plain_version_on_cpu_counts_no_launch():
    rng = np.random.default_rng(4)
    arrays = random_heap_forest(rng, trees=5, height=4, features=2)
    tables = walk.walk_tables(forest_from_arrays(*arrays, device="cpu"))
    X = torch.from_numpy(rows(rng, 64, 2))
    before = walk.walk_sum.launches
    got = walk.walk_sum(X, tables)
    assert walk.walk_sum.launches == before
    assert torch.equal(got, walk.walk_sum_plain(X, tables))


def test_wrapper_checks_inputs():
    rng = np.random.default_rng(6)
    tables = walk.walk_tables(forest_from_arrays(*random_heap_forest(rng, 3, 3, 2), device="cpu"))
    with pytest.raises(ValueError, match="contiguous float32"):
        walk.walk_sum(torch.zeros(4, 2, dtype=torch.float64), tables)
    with pytest.raises(ValueError, match="at least one feature"):
        walk.walk_sum(torch.zeros(4, 0), tables)
    with pytest.raises(ValueError, match="walk table 'feature'"):
        walk.walk_sum(torch.zeros(4, 2), tables._replace(feature=tables.feature.long()))
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        walk.walk_sum(torch.zeros(4, 2, device="meta"), walk.WalkTables(*(t.to("meta") for t in tables)))
