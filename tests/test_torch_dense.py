"""The PyTorch port's dense level walk (``ops/dense.py``, the plain version
of ``csrc/dense.cu``) against the JAX package's dense kernel
(``pallas_traversal.path_lengths_pallas`` in interpret mode) and XLA dense
walk (``dense_traversal.standard_path_lengths_dense``), on the CPU.

Each tree's path length is one leaf value, and the port adds ``pl / T``
tree by tree, as the Pallas kernel's source does. So with a power-of-two
tree count and leaf sizes whose ``c(n)`` torch and XLA compute alike, the
port agrees with both JAX paths bit for bit. Elsewhere two things move the
last bits: torch's and XLA's float32 ``log`` differ by an ulp at a few leaf
sizes, and XLA on the CPU rewrites the kernel's ``pl / T`` into a
multiply-add with the rounded ``1 / T``. At path lengths of 8 to 16 an ulp
is 9.5e-7, and the mean can move by two: atol 2e-6 against the Pallas
kernel. The XLA dense walk sums the trees and divides once, so each of the
port's T quotients rounds on its own: atol 1e-5 against it, as for the
walk's different summation orders.
"""

from __future__ import annotations

import pathlib

import numpy as np
import pytest
import torch

from isoforest_tpu.models import IsolationForestModel as JaxModel
from isoforest_tpu.ops.dense_traversal import standard_path_lengths_dense as jax_dense
from isoforest_tpu.ops.pallas_traversal import path_lengths_pallas as jax_pallas
from isoforest_tpu.ops.traversal import standard_path_lengths as jax_gather
from isoforest_tpu.ops.tree_growth import StandardForest as JaxForest
from isoforest_tpu.utils.math import avg_path_length as jax_c
from isoforest_tpu_torch.io.interop import forest_from_arrays
from isoforest_tpu_torch.ops import dense, walk
from isoforest_tpu_torch.testing import finite_rows, random_heap_forest, rows
from isoforest_tpu_torch.utils.math import avg_path_length as port_c

FIXTURE = pathlib.Path(__file__).parent / "resources" / "torch_port" / "mammography_std" / "model"
ATOL = 2e-6
ALL_SIZES = np.arange(0, 300)


def sizes_with_equal_c() -> np.ndarray:
    """Leaf sizes whose c(n) the two packages compute bit for bit."""
    return ALL_SIZES[port_c(ALL_SIZES).numpy() == np.asarray(jax_c(ALL_SIZES))]


def _port_dense(arrays, X) -> np.ndarray:
    forest = forest_from_arrays(*arrays, device="cpu")
    return dense.standard_path_lengths_dense(forest, torch.from_numpy(X)).numpy()


@pytest.mark.parametrize("features,n", [(12, 1025), (13, 1023), (3, 1)])
def test_dense_matches_jax_bitwise(features, n):
    """Both sides of the F = 12/13 select split, 8 trees, leaf sizes with
    equal c(n): the port, the Pallas kernel and the XLA dense walk agree
    bit for bit."""
    rng = np.random.default_rng(features)
    arrays = random_heap_forest(rng, trees=8, height=5, features=features, sizes=sizes_with_equal_c())
    X = finite_rows(rng, n, features)
    got = _port_dense(arrays, X)
    jf = JaxForest(*arrays)
    np.testing.assert_array_equal(got, np.asarray(jax_pallas(jf, X, interpret=True)))
    np.testing.assert_array_equal(got, np.asarray(jax_dense(jf, X)))


@pytest.mark.parametrize("features,n", [(12, 1025), (13, 1023)])
def test_dense_matches_jax_any_tree_count_and_leaf_size(features, n):
    rng = np.random.default_rng(20 + features)
    arrays = random_heap_forest(rng, trees=9, height=5, features=features)
    X = finite_rows(rng, n, features)
    got = _port_dense(arrays, X)
    jf = JaxForest(*arrays)
    np.testing.assert_allclose(got, np.asarray(jax_pallas(jf, X, interpret=True)), rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(jax_dense(jf, X)), rtol=0, atol=1e-5)


@pytest.mark.parametrize("height", [0, 1, 8, 10])
@pytest.mark.parametrize("features", [1, 6, 12, 13])
def test_bits_then_path_matches_jax_pallas_kernel(height, features):
    """The plain version's steps (every internal-capable slot's go-right
    bit, then each row's path along them) against the Pallas kernel's level
    walk, at heights 0 to the fence and on both sides of the JAX package's
    select split: 8 trees, leaf sizes with equal c(n), bit for bit."""
    rng = np.random.default_rng(100 * height + features)
    arrays = random_heap_forest(rng, trees=8, height=height, features=features, sizes=sizes_with_equal_c())
    X = finite_rows(rng, 300, features)
    got = _port_dense(arrays, X)
    np.testing.assert_array_equal(got, np.asarray(jax_pallas(JaxForest(*arrays), X, interpret=True)))


def test_fixture_slice_matches_jax_pallas_kernel(mammography):
    """16 trees of the JAX-written mammography model, 2,048 rows."""
    X = np.ascontiguousarray(mammography[0][:2048])
    jm = JaxModel.load(str(FIXTURE))
    arrays = tuple(np.asarray(a)[:16] for a in jm.forest)
    got = _port_dense(arrays, X)
    want = np.asarray(jax_pallas(JaxForest(*arrays), X, interpret=True))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("features", [5, 12, 13])
def test_nonfinite_rows_route_like_the_gather_walk(features):
    """NaN goes left and +-inf compare as numbers at every F. (The JAX
    package's one-hot product above F = 12 turns a row with any non-finite
    entry into NaN at every slot; the port reads x[feature] exactly.)"""
    rng = np.random.default_rng(40 + features)
    arrays = random_heap_forest(rng, trees=7, height=5, features=features)
    X = rows(rng, 500, features)
    got = _port_dense(arrays, X)
    np.testing.assert_allclose(got, np.asarray(jax_gather(JaxForest(*arrays), X)), rtol=0, atol=1e-5)
    wt = walk.walk_tables(forest_from_arrays(*arrays, device="cpu"))
    np.testing.assert_allclose(got, walk.path_lengths_walk(torch.from_numpy(X), wt).numpy(), rtol=0, atol=1e-5)


def test_height_fence():
    rng = np.random.default_rng(8)
    X = torch.from_numpy(finite_rows(rng, 64, 3))
    at_fence = forest_from_arrays(*random_heap_forest(rng, 3, dense.DENSE_MAX_HEIGHT, 3, 0.5), device="cpu")
    got = dense.standard_path_lengths_dense(at_fence, X)
    wt = walk.walk_tables(at_fence)
    torch.testing.assert_close(got, walk.path_lengths_walk(X, wt), rtol=0, atol=1e-5)
    above = forest_from_arrays(*random_heap_forest(rng, 2, dense.DENSE_MAX_HEIGHT + 1, 3, 0.5), device="cpu")
    with pytest.raises(ValueError, match="DENSE_MAX_HEIGHT=10"):
        dense.standard_path_lengths_dense(above, X)
    with pytest.raises(ValueError, match="DENSE_MAX_HEIGHT=10"):
        dense.dense_mean(X, dense.pack_standard(above))


def test_plain_version_on_cpu_counts_no_launch():
    rng = np.random.default_rng(9)
    tables = dense.pack_standard(forest_from_arrays(*random_heap_forest(rng, 4, 4, 2), device="cpu"))
    X = torch.from_numpy(finite_rows(rng, 33, 2))
    before = dense.dense_mean.launches
    got = dense.dense_mean(X, tables)
    assert dense.dense_mean.launches == before
    assert torch.equal(got, dense.dense_mean_plain(X, tables))


def test_wrapper_checks_inputs():
    rng = np.random.default_rng(10)
    tables = dense.pack_standard(forest_from_arrays(*random_heap_forest(rng, 3, 3, 2), device="cpu"))
    with pytest.raises(ValueError, match="contiguous float32"):
        dense.dense_mean(torch.zeros(4, 2).t(), tables)
    with pytest.raises(ValueError, match="dense table 'value'"):
        dense.dense_mean(torch.zeros(4, 2), tables._replace(value=tables.value.double()))
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        dense.dense_mean(torch.zeros(4, 2, device="meta"), type(tables)(*(t.to("meta") for t in tables)))
