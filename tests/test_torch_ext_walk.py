"""The PyTorch port's EIF walk (``ops/ext_walk.py``, the plain version of
``csrc/path_walk.cu``) and EIF gather walk (``ops/traversal.py``) against
the JAX package's walk kernel ``_extended_walk``
(``pallas_walk.path_lengths_walk`` in interpret mode) and gather walk, on
the CPU.

The port rounds each hyperplane dot step by step in the order XLA:CPU gives
its counterpart, so every ``dot == offset`` tie routes as the counterpart
routes it. A flipped tie moves a mean path length by at least 1/T of a
level (over 0.06 here). What is left are the last bits of the sum over
trees, which the three paths add in different orders (the walk kernel in
8-tree sublane blocks, the port in tree order, the gather walk per 8-tree
block), and the float32 ``log`` in leaf values (torch's and XLA's differ by
up to an ulp): atol 1e-5 on mean path length, as for the standard walk.
The paired walk order and the gather order differ, and on tie-heavy rows
the tests show that they route ties differently.
"""

from __future__ import annotations

import pathlib

import numpy as np
import pytest
import torch

from isoforest_tpu.models import ExtendedIsolationForestModel as JaxModel
from isoforest_tpu.ops.ext_growth import ExtendedForest as JaxForest
from isoforest_tpu.ops.pallas_traversal import _concat_order
from isoforest_tpu.ops.pallas_walk import _WALK_K_MAX, _level_layout
from isoforest_tpu.ops.pallas_walk import path_lengths_walk as jax_walk
from isoforest_tpu.ops.pallas_walk import walk_tables_extended as jax_walk_tables
from isoforest_tpu.ops.traversal import extended_path_lengths as jax_gather
from isoforest_tpu.utils.math import leaf_value_table as jax_leaf_values
from isoforest_tpu_torch.io.interop import extended_forest_from_arrays
from isoforest_tpu_torch.ops import ext_path, ext_walk
from isoforest_tpu_torch.ops.traversal import extended_path_lengths
from isoforest_tpu_torch.testing import random_extended_forest, rows
from isoforest_tpu_torch.utils.math import fma_f32

FIXTURE = pathlib.Path(__file__).parent / "resources" / "torch_port" / "mammography_eif" / "model"
ATOL = 1e-5


def quantized_rows(rng, n: int, features: int) -> np.ndarray:
    """TestQuantizedTieRouting's recipe: integers 0..3, so deep nodes see
    constant coordinates and exact ties."""
    return rng.integers(0, 4, size=(n, features)).astype(np.float32)


def _port_walk(arrays, X) -> np.ndarray:
    tables = ext_walk.walk_tables_extended(extended_forest_from_arrays(*arrays, device="cpu"))
    return ext_walk.path_lengths_ext_walk(torch.from_numpy(X), tables).numpy()


def _port_gather(arrays, X) -> np.ndarray:
    return extended_path_lengths(extended_forest_from_arrays(*arrays, device="cpu"), torch.from_numpy(X)).numpy()


def test_paired_order_fence_is_the_jax_packages():
    assert ext_walk.PAIRED_MAX_K == _WALK_K_MAX == 16


@pytest.mark.parametrize(
    "k,features,make_rows",
    [(1, 5, rows), (6, 6, rows), (16, 16, rows), (2, 5, quantized_rows), (6, 6, quantized_rows)],
)
def test_walk_matches_jax_walk_kernel(k, features, make_rows):
    """Rows with NaN and +-inf, or tie-heavy quantized rows; intercepts are
    drawn from the rows, so exact ties occur; some nodes keep unused
    coordinates (x[0] * 0)."""
    rng = np.random.default_rng(100 * k + features)
    X = make_rows(rng, 1025, features)
    height = 5 if k < 16 else 3  # interpret-mode compile time grows with k * height
    arrays = random_extended_forest(rng, 8, height, features, k, intercepts=X[:32], unused_p=0.3)
    got = _port_walk(arrays, X)
    want = np.asarray(jax_walk(JaxForest(*arrays), X, interpret=True))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_gather_walk_matches_jax_gather_and_the_walk_differs_on_ties():
    """On tie-heavy rows the port's gather walk routes every tie as the JAX
    gather walk does, while the walk kernel's own order routes some of
    them the other way, in both packages alike."""
    rng = np.random.default_rng(7)
    X = quantized_rows(rng, 2048, 5)
    arrays = random_extended_forest(rng, 16, 5, 5, 3, intercepts=X[:16])
    got = _port_gather(arrays, X)
    want = np.asarray(jax_gather(JaxForest(*arrays), X))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    walk = _port_walk(arrays, X)
    flipped = np.abs(walk - got) > ATOL
    assert flipped.any(), "expected tie flips between the walk and gather orders"
    jax_flipped = np.abs(np.asarray(jax_walk(JaxForest(*arrays), X, interpret=True)) - want) > ATOL
    np.testing.assert_array_equal(flipped, jax_flipped)


def test_wide_k_walk_takes_the_gather_order():
    """Above the reference walk kernel's k fence the port's walk is held to
    the gather walk (k = 24), ties and non-finite rows included."""
    rng = np.random.default_rng(24)
    X = rows(rng, 1023, 26)
    arrays = random_extended_forest(rng, 8, 4, 26, 24, intercepts=X[:8], unused_p=0.2)
    want = np.asarray(jax_gather(JaxForest(*arrays), X))
    np.testing.assert_allclose(_port_walk(arrays, X), want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(_port_gather(arrays, X), want, rtol=0, atol=ATOL)


def test_fixture_slice_matches_jax_walk_kernel_and_gather(mammography):
    """16 trees of the JAX-written mammography EIF, 2,048 rows (mammography
    is tie-heavy: the walk and gather orders split many rows)."""
    X = np.ascontiguousarray(mammography[0][:2048])
    jm = JaxModel.load(str(FIXTURE))
    arrays = tuple(np.asarray(a)[:16] for a in jm.forest)
    jf = JaxForest(*arrays)
    np.testing.assert_allclose(_port_walk(arrays, X), np.asarray(jax_walk(jf, X, interpret=True)), rtol=0, atol=ATOL)
    np.testing.assert_allclose(_port_gather(arrays, X), np.asarray(jax_gather(jf, X)), rtol=0, atol=ATOL)


def test_gather_walk_matches_jax_gather_on_nonfinite_rows():
    rng = np.random.default_rng(11)
    X = rows(rng, 777, 6)
    arrays = random_extended_forest(rng, 9, 5, 6, 4, unused_p=0.5)
    np.testing.assert_allclose(_port_gather(arrays, X), np.asarray(jax_gather(JaxForest(*arrays), X)), rtol=0, atol=ATOL)


def heap_of_walk_layout(table: np.ndarray, m: int, planes: int = 1) -> np.ndarray:
    """A JAX walk-layout table ``[T_pad, planes * L]`` back in heap order,
    ``[T_pad, M]`` (``[T_pad, M, planes]`` when ``planes > 1``)."""
    h = int(np.log2(m + 1)) - 1
    offs, _, lanes = _level_layout(h)
    order = list(_concat_order(m))
    lane = np.zeros(m, np.int64)
    pos = 0
    for level in range(h + 1):
        lane[order[pos : pos + (1 << level)]] = offs[level] + np.arange(1 << level)
        pos += 1 << level
    heap = np.stack([table[:, q * lanes + lane] for q in range(planes)], axis=2)
    return heap[..., 0] if planes == 1 else heap


@pytest.mark.parametrize("k,features", [(3, 5), (6, 300)])
def test_walk_tables_sentinels(k, features):
    """The walk's records hold the JAX package's ``walk_tables_extended``
    (level-major, lane-packed planes), taken back to heap order: each
    internal node's offset, k clamped indices and weights (0 at unused
    coordinates), its children as record links or the leaf LUT value
    (``depth + c(n)``, 0 at holes), records tree by tree in heap order."""
    rng = np.random.default_rng(2)
    arrays = random_extended_forest(rng, 4, 4, features, k, unused_p=0.5)
    indices = arrays[0]
    tables = ext_walk.walk_tables_extended(extended_forest_from_arrays(*arrays, device="cpu"))
    m = indices.shape[1]
    off, idx, w, leaf = (np.asarray(a) for a in jax_walk_tables(JaxForest(*arrays), 4))
    off, leaf = heap_of_walk_layout(off, m)[:4], heap_of_walk_layout(leaf, m)[:4]
    idx, w = heap_of_walk_layout(idx, m, k)[:4], heap_of_walk_layout(w, m, k)[:4]
    internal = indices[..., 0] >= 0
    assert np.isposinf(off[~internal]).all()
    offset, left, right, terms, index, weight = (a.numpy() for a in ext_path.record_fields(tables))
    tt, ss = np.nonzero(internal)
    np.testing.assert_array_equal(offset, off[tt, ss])
    np.testing.assert_array_equal(index, idx[tt, ss])
    np.testing.assert_array_equal(weight, w[tt, ss])
    assert (terms == k).all()
    record = np.full(internal.shape, -1)
    record[tt, ss] = np.arange(len(tt))

    def decoded(code, t, slot):
        """What a child code says, checked against the heap tables."""
        if code < 0:
            assert record[t, slot] == ~code
        else:
            assert not internal[t, slot] and np.float32(leaf[t, slot]) == np.int32(code).view(np.float32)

    for r, (t, s_) in enumerate(zip(tt, ss)):
        decoded(left[r], t, 2 * s_ + 1)
        decoded(right[r], t, 2 * s_ + 2)
    for t, code in enumerate(tables.roots.numpy()):
        decoded(code, t, 0)
    np.testing.assert_allclose(leaf, jax_leaf_values(arrays[3], 4), rtol=0, atol=1e-6)
    assert tables.height == 4 and tables.num_trees == 4 and tables.k == k
    assert tables.min_features == indices.max() + 1
    assert tables.chunk_terms == 3 and tables.records.shape[1] == 4 * (1 + -(-k // 3))


def test_root_leaf_tree_and_hole_chain():
    """A root leaf of size 1 (leaf value 0) keeps walking the hole chain,
    even right on +inf rows, and adds exactly 0."""
    m = 2**3 - 1
    indices = np.full((1, m, 2), -1, np.int32)
    num_instances = np.full((1, m), -1, np.int32)
    num_instances[0, 0] = 1
    X = np.array([[np.inf, 1.0], [-1.0, np.inf], [np.nan, 0.0]], np.float32)
    got = _port_walk((indices, np.zeros((1, m, 2), np.float32), np.zeros((1, m), np.float32), num_instances), X)
    assert (got == 0).all()


def test_hyperplane_dot_order():
    """Up to 16 coordinates: x1*w1, then fma(x0, w0, .), then the rest in
    order; above: an FMA chain from 0. Here x0*w0 = 1 + 3*2^-23 + 2^-45 is
    inexact and x1*w1 = -1 exact, so the paired order keeps the 2^-45 that
    the chain rounds away."""
    X = torch.tensor([[1.0 + 2**-23, 1.0]], dtype=torch.float32)
    w = torch.tensor([[1.0 + 2**-22, -1.0]], dtype=torch.float32)
    idx = torch.tensor([[0, 1]], dtype=torch.int32)
    got = ext_path.hyperplane_dot(X, idx, w)
    assert got.item() == 3 * 2**-23 + 2**-45
    wide_idx = torch.zeros((1, 17), dtype=torch.int32)
    wide_w = torch.zeros((1, 17), dtype=torch.float32)
    wide_idx[0, :2], wide_w[0, :2] = idx[0], w[0]
    assert ext_path.hyperplane_dot(X, wide_idx, wide_w).item() == 3 * 2**-23


def test_fma_f32_rounds_once():
    """a*b + c rounded once to float32, also where the float64 sum lands
    exactly halfway between two float32 values (1 + 2^-24 + 4688 * 2^-70
    rounds up; rounded twice through float64 it would go to even, 1.0)."""
    m1, m2 = 2**23 + 2896, 2**23 - 2895
    a = torch.tensor([m1 / 2**35, -m1 / 2**35, 3.0, np.inf], dtype=torch.float32)
    b = torch.tensor([m2 / 2**35, m2 / 2**35, 0.0, 0.0], dtype=torch.float32)
    c = torch.tensor([1.0, -1.0, 2.0, 1.0], dtype=torch.float32)
    got = fma_f32(a, b, c)
    assert got[0].item() == 1.0 + 2**-23 and got[1].item() == -(1.0 + 2**-23)
    assert got[2].item() == 2.0 and np.isnan(got[3].item())
    rng = np.random.default_rng(0)
    A, B, C = (torch.from_numpy(rng.normal(size=20000).astype(np.float32)) for _ in range(3))
    naive = (A.double() * B.double() + C.double()).float()
    assert torch.equal(fma_f32(A, B, C), naive)  # no halfway sums among these


def test_plain_version_on_cpu_counts_no_launch():
    rng = np.random.default_rng(4)
    tables = ext_walk.walk_tables_extended(
        extended_forest_from_arrays(*random_extended_forest(rng, 5, 4, 3, 2), device="cpu")
    )
    X = torch.from_numpy(rows(rng, 64, 3))
    before = dict(ext_path.launches)
    got = ext_walk.ext_walk_sum(X, tables)
    assert ext_path.launches == before
    assert torch.equal(got, ext_walk.ext_walk_sum_plain(X, tables))


def test_wrapper_checks_inputs():
    rng = np.random.default_rng(6)
    tables = ext_walk.walk_tables_extended(
        extended_forest_from_arrays(*random_extended_forest(rng, 3, 3, 2, 2), device="cpu")
    )
    with pytest.raises(ValueError, match="contiguous float32"):
        ext_walk.ext_walk_sum(torch.zeros(4, 2, dtype=torch.float64), tables)
    with pytest.raises(ValueError, match="at least one feature"):
        ext_walk.ext_walk_sum(torch.zeros(4, 0), tables)
    with pytest.raises(ValueError, match="ext_walk_sum table 'records'"):
        ext_walk.ext_walk_sum(torch.zeros(4, 2), tables._replace(records=tables.records.long()))
    with pytest.raises(ValueError, match="ext_walk_sum table 'records' has 4 words a record"):
        ext_walk.ext_walk_sum(torch.zeros(4, 2), tables._replace(records=tables.records[:, :4].contiguous()))
    with pytest.raises(ValueError, match="ext_walk_sum table 'roots'"):
        ext_walk.ext_walk_sum(torch.zeros(4, 2), tables._replace(roots=tables.roots[None]))
    with pytest.raises(ValueError, match="X has 1 features, but the ext_walk_sum tables read feature 1"):
        ext_walk.ext_walk_sum(torch.zeros(4, 1), tables)
    on_meta = {name: getattr(tables, name).to("meta") for name in ("records", "roots")}
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        ext_walk.ext_walk_sum(torch.zeros(4, 2, device="meta"), tables._replace(**on_meta))


@pytest.mark.parametrize("k,features,height", [(6, 6, 0), (6, 6, 1), (16, 17, 2), (2, 3, 6)])
def test_walk_edges_match_jax_walk_kernel(k, features, height):
    """Heights 0 and 1 (root-leaf trees and single splits), the paired
    order's widest k, a deep narrow forest; tie-heavy rows with NaN and
    +-inf mixed in."""
    rng = np.random.default_rng(700 + 10 * k + height)
    X = quantized_rows(rng, 515, features)
    X[::9, 0], X[4::17, features - 1] = np.nan, np.inf
    arrays = random_extended_forest(rng, 8, height, features, k, intercepts=X[:32], unused_p=0.3)
    want = np.asarray(jax_walk(JaxForest(*arrays), X, interpret=True))
    np.testing.assert_allclose(_port_walk(arrays, X), want, rtol=0, atol=ATOL)


def test_duplicate_coordinates_are_two_terms_as_in_the_jax_walk_kernel():
    """The walk merges nothing: a coordinate listed twice is two terms, in
    the paired order, as in the reference's walk kernel."""
    rng = np.random.default_rng(31)
    X = quantized_rows(rng, 256, 4)
    X[::5, 3] = np.inf
    m = 7
    indices = np.full((2, m, 3), -1, np.int32)
    weights = np.zeros((2, m, 3), np.float32)
    indices[:, 0], weights[:, 0] = [3, 1, 3], [0.5, -0.25, 0.75]
    indices[:, 2], weights[:, 2] = [0, 0, 2], [1.0, -1.0, 0.5]
    offset = np.zeros((2, m), np.float32)
    offset[:, 0], offset[:, 2] = 1.0, 0.5
    num_instances = np.full((2, m), -1, np.int32)
    num_instances[:, [1, 5, 6]] = [[3, 40, 7], [9, 1, 120]]
    arrays = (indices, weights, offset, num_instances)
    want = np.asarray(jax_walk(JaxForest(*arrays), X, interpret=True))
    np.testing.assert_allclose(_port_walk(arrays, X), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("features,chunk_terms", [(1024, 3), (1025, 2)])
def test_wide_rows_take_wider_record_indices(features, chunk_terms):
    """Up to 1,024 features the records pack three 10-bit indices to a
    chunk, above that two i32 ones; the walk (k = 18, the gather order)
    still routes like the gather walk."""
    rng = np.random.default_rng(features)
    X = rows(rng, 64, features)
    arrays = random_extended_forest(rng, 4, 3, features, 18, intercepts=X[:8], unused_p=0.2)
    arrays[0][1, 0, 0] = features - 1  # the widest feature is read
    forest = extended_forest_from_arrays(*arrays, device="cpu")
    tables = ext_walk.walk_tables_extended(forest)
    assert tables.chunk_terms == chunk_terms and tables.min_features == features
    got = ext_walk.path_lengths_ext_walk(torch.from_numpy(X), tables)
    torch.testing.assert_close(got, extended_path_lengths(forest, torch.from_numpy(X)), rtol=0, atol=ATOL)

