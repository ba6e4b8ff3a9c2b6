"""The PyTorch port's O(h) walk (``ops/walk.py``, the plain version of
``walk_sum`` in ``csrc/path_walk.cu``) and gather walk against the JAX
package's walk kernel (``pallas_walk._standard_walk`` in interpret mode) and
gather walk, on the CPU.

Tolerance: bitwise where the two walks read the same leaf values and add
trees in the same order; else atol 1e-5 on mean path length. The leaf
values hold a float32 ``log`` (torch's and XLA's differ by up to an ulp),
and the three paths sum trees in different orders: the gather walk per
8-tree block, the JAX walk kernel per 8-tree sublane block, the port over
all trees in tree order, then divide by T.
"""

from __future__ import annotations

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isoforest_tpu.models import IsolationForestModel as JaxModel
from isoforest_tpu.ops.pallas_walk import _ROW_TILE, _standard_walk, _to_walk_layout
from isoforest_tpu.ops.pallas_walk import path_lengths_walk as jax_walk
from isoforest_tpu.ops.traversal import standard_path_lengths as jax_gather
from isoforest_tpu.ops.tree_growth import StandardForest as JaxForest
from isoforest_tpu.utils.math import leaf_value_table as jax_leaf_values
from isoforest_tpu_torch.io.interop import forest_from_arrays
from isoforest_tpu_torch.ops import ext_path, walk
from isoforest_tpu_torch.ops.scoring_layout import leaf_lut
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


def _jax_walk_sum_in_tree_order(arrays, X: np.ndarray, leaf: np.ndarray) -> np.ndarray:
    """The JAX package's walk kernel ``_standard_walk`` (interpret mode) with
    tree t alone in its 8-tree sublane block t: the block's seven other
    trees are +inf thresholds over 0 leaf values and add +0.0 at every
    level, so a block's sublane sum is tree t's path length exactly and the
    kernel's block-by-block accumulation is the sum over trees in tree
    order. ``leaf``: the heap leaf table the kernel reads."""
    feature, threshold, _ = arrays
    t_n, m = feature.shape
    h = int(np.log2(m + 1)) - 1
    internal = feature >= 0
    planes = []
    for heap, fill in ((np.where(internal, threshold, np.inf).astype(np.float32), np.inf),
                       (np.maximum(feature, 0).astype(np.int32), 0),
                       (leaf.astype(np.float32), 0.0)):
        level_major = _to_walk_layout(heap, h, fill)
        spread = np.full((8 * t_n, level_major.shape[1]), fill, level_major.dtype)
        spread[::8] = level_major
        planes.append(jnp.asarray(spread))
    n, f = X.shape
    padded = np.zeros((-(-n // _ROW_TILE) * _ROW_TILE, f), np.float32)
    padded[:n] = X
    return np.asarray(_standard_walk(jnp.asarray(padded), *planes, h, f, interpret=True))[:n]


@pytest.mark.parametrize(
    "features,height,trees,n",
    [(5, 0, 4, 9), (3, 12, 3, 1025), (1, 7, 9, 1023), (1025, 3, 5, 300)],
    ids=["h0_root_leaves", "h12", "f1", "f1025"],
)
def test_plain_walk_equals_jax_walk_kernel_bitwise(features, height, trees, n):
    """The record walk's sum in tree order equals the JAX walk kernel's bit
    for bit on rows with NaN and +-inf, read from the same leaf table (the
    port's; the JAX package's own rounds its ``log`` within an ulp of it,
    ``test_walk_tables_sentinels``)."""
    rng = np.random.default_rng(features * 10 + height)
    arrays = random_heap_forest(rng, trees=trees, height=height, features=features)
    X = rows(rng, n, features)
    forest = forest_from_arrays(*arrays, device="cpu")
    got = walk.walk_sum(torch.from_numpy(X), walk.walk_tables(forest)).numpy()
    want = _jax_walk_sum_in_tree_order(arrays, X, leaf_lut(forest.num_instances, forest.max_nodes).numpy())
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def _check_records(tables, feature, threshold, num_instances):
    """Each internal slot's record, tree by tree in heap order: its
    threshold, feature and children, a child code being a record link or
    the bits of the leaf LUT's ``depth + c(n)``."""
    internal = feature >= 0
    tt, ss = np.nonzero(internal)
    assert tables.k == 0 and tables.records.shape == (len(tt), 4)
    thr, left, right, feat, index, weight = (a.numpy() for a in ext_path.record_fields(tables))
    assert index.shape == weight.shape == (len(tt), 0)
    np.testing.assert_array_equal(thr, threshold[tt, ss])
    np.testing.assert_array_equal(feat, feature[tt, ss])
    record = np.full(internal.shape, -1)
    record[tt, ss] = np.arange(len(tt))
    leaf = leaf_lut(torch.from_numpy(num_instances), feature.shape[1]).numpy()

    def decoded(code, t, slot):
        if code < 0:
            assert record[t, slot] == ~code
        else:
            assert not internal[t, slot] and leaf[t, slot] == np.int32(code).view(np.float32)

    for r, (t, s_) in enumerate(zip(tt, ss)):
        decoded(left[r], t, 2 * s_ + 1)
        decoded(right[r], t, 2 * s_ + 2)
    for t, code in enumerate(tables.roots.numpy()):
        decoded(code, t, 0)
    assert tables.min_features == (feature.max() + 1 if internal.any() else 1)


def test_walk_tables_sentinels():
    """Header-only records ``(threshold, left, right, feature)``, a leaf a
    child code (+0.0 at a hole); the leaf LUT within an ulp of the JAX
    package's (torch's and XLA's ``log``)."""
    rng = np.random.default_rng(2)
    for trees, height, features in ((4, 4, 3), (6, 9, 300)):
        feature, threshold, num_instances = random_heap_forest(rng, trees=trees, height=height, features=features)
        tables = walk.walk_tables(forest_from_arrays(feature, threshold, num_instances, device="cpu"))
        _check_records(tables, feature, threshold, num_instances)
        leaf = leaf_lut(torch.from_numpy(num_instances), feature.shape[1]).numpy()
        np.testing.assert_allclose(leaf, jax_leaf_values(num_instances, height), rtol=0, atol=1e-6)
        assert tables.height == height and tables.num_trees == trees and tables.chunk_terms == 3


def test_fixture_records():
    """The committed mammography model: 100 trees, 5,168 internal nodes,
    one 16-byte record each (83 KB)."""
    feature, threshold, num_instances = (np.asarray(a) for a in JaxModel.load(str(FIXTURE)).forest)
    tables = walk.walk_tables(forest_from_arrays(feature, threshold, num_instances, device="cpu"))
    assert tables.records.shape == (5168, 4) and tables.records.numel() * 4 == 82688
    assert tables.num_trees == 100 and tables.height == 8 and tables.min_features == 6
    _check_records(tables, feature, threshold, num_instances)


def test_root_leaf_tree_and_hole_chain():
    """A tree that is a root leaf of size 1 has no record: its root code is
    the bits of +0.0, a hole's value, and every row, +inf and NaN ones too,
    adds exactly 0 (the heap walk kept such a row on the hole chain). A
    split tree's leaf of size 0 or 1 adds its depth."""
    m = 2**3 - 1
    feature = np.full((2, m), -1, np.int32)
    num_instances = np.full((2, m), -1, np.int32)
    num_instances[0, 0] = 1
    feature[1, 0] = 0
    num_instances[1, 1:3] = (0, 1)
    threshold = np.zeros((2, m), np.float32)
    tables = walk.walk_tables(forest_from_arrays(feature, threshold, num_instances, device="cpu"))
    assert tables.records.shape == (1, 4) and tables.roots.tolist() == [0, ~0]
    X = np.array([[np.inf], [-1.0], [np.nan]], np.float32)
    got = walk.walk_sum(torch.from_numpy(X), tables)
    assert got.tolist() == [1.0, 1.0, 1.0]


@pytest.mark.parametrize("trees", [1, 31, 32, 33, 100])
def test_small_batch_and_bulk_plain_walks_agree(trees):
    """The plain walk of the small-batch launch (32 trees side by side)
    and of the bulk launch (tree by tree) add the same path lengths in the
    same order: equal bit for bit."""
    rng = np.random.default_rng(trees)
    arrays = random_heap_forest(rng, trees=trees, height=7, features=6)
    tables = walk.walk_tables(forest_from_arrays(*arrays, device="cpu"))
    X = torch.from_numpy(rows(rng, 257, 6))
    bulk = walk.walk_sum_plain(X, tables)
    assert torch.equal(walk.walk_sum_plain(X, tables, tree_parallel=True), bulk)
    assert torch.equal(walk.walk_sum(X, tables), bulk)


def test_plain_version_on_cpu_counts_no_launch():
    rng = np.random.default_rng(4)
    arrays = random_heap_forest(rng, trees=5, height=4, features=2)
    tables = walk.walk_tables(forest_from_arrays(*arrays, device="cpu"))
    X = torch.from_numpy(rows(rng, 64, 2))
    before = dict(ext_path.launches)
    got = walk.walk_sum(X, tables)
    assert ext_path.launches == before
    assert torch.equal(got, walk.walk_sum_plain(X, tables))


def test_wrapper_checks_inputs():
    rng = np.random.default_rng(6)
    tables = walk.walk_tables(forest_from_arrays(*random_heap_forest(rng, 3, 3, 2), device="cpu"))
    with pytest.raises(ValueError, match="contiguous float32"):
        walk.walk_sum(torch.zeros(4, 2, dtype=torch.float64), tables)
    with pytest.raises(ValueError, match="at least one feature"):
        walk.walk_sum(torch.zeros(4, 0), tables)
    with pytest.raises(ValueError, match="walk_sum table 'records'"):
        walk.walk_sum(torch.zeros(4, 2), tables._replace(records=tables.records.long()))
    with pytest.raises(ValueError, match="walk_sum table 'roots'"):
        walk.walk_sum(torch.zeros(4, 2), tables._replace(roots=tables.roots[None]))
    with pytest.raises(ValueError, match="walk_sum takes header-only records, got records of k = 2 terms"):
        walk.walk_sum(torch.zeros(4, 2), tables._replace(records=torch.zeros(3, 8, dtype=torch.int32), k=2))
    with pytest.raises(ValueError, match="ext_walk_sum takes hyperplane records, got records of k = 0 terms"):
        ext_path.check_records(torch.zeros(4, 2), tables, "ext_walk_sum")
    with pytest.raises(ValueError, match="X has 1 features, but the walk_sum tables read feature 1"):
        walk.walk_sum(torch.zeros(4, 1), tables)
    on_meta = {name: getattr(tables, name).to("meta") for name in ("records", "roots")}
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        walk.walk_sum(torch.zeros(4, 2, device="meta"), tables._replace(**on_meta))
