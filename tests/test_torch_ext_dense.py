"""The PyTorch port's EIF dense level walks (``ops/ext_dense.py``, the plain
versions of ``ext_sparse_mean`` of ``csrc/path_walk.cu`` and of
``csrc/ext_gemm.cu``) against the JAX package's ``_extended_pallas_sparse``
(k <= 32) and ``_extended_pallas_dense`` (k > 32), both through
``pallas_traversal.path_lengths_pallas`` in interpret mode, on the CPU.

XLA:CPU computes the reference's ``X @ W`` as an FMA chain over features
from 0, and the port takes that chain over each node's coordinates, so on
finite rows every dot, and every ``dot == offset`` tie, is the reference's
bit for bit. Each tree's path length is one leaf value and the port adds
``pl / T`` tree by tree, as the kernels' source does; XLA:CPU rewrites
that into a multiply-add with the rounded ``1 / T``, which is exact for a
power-of-two T. So with T = 8 and leaf sizes whose ``c(n)`` torch and XLA
compute alike, the port equals both kernels bit for bit, on tie-heavy rows
too. Elsewhere (the fixture's leaf sizes) atol 2e-6, as for the standard
dense kernel.

Rows with NaN or +-inf: the reference's product makes such a row NaN at
every slot; the port routes them like the gather walk (only the node's own
coordinates, plus ``x[0] * 0`` for each unused one), and is held to the
JAX gather walk there (atol 1e-5: the gather walk sums trees in 8-tree
blocks and divides once).
"""

from __future__ import annotations

import pathlib
import re

import numpy as np
import pytest
import torch

from isoforest_tpu.models import ExtendedIsolationForestModel as JaxModel
from isoforest_tpu.ops.ext_growth import ExtendedForest as JaxForest
from isoforest_tpu.ops.pallas_traversal import _SPARSE_K_MAX, _concat_order
from isoforest_tpu.ops.pallas_traversal import dense_hyperplane_table as jax_dense_table
from isoforest_tpu.ops.pallas_traversal import path_lengths_pallas as jax_pallas
from isoforest_tpu.ops.pallas_traversal import sparse_hyperplane_tables as jax_sparse_tables
from isoforest_tpu.ops.traversal import extended_path_lengths as jax_gather
from isoforest_tpu.utils.math import avg_path_length as jax_c
from isoforest_tpu_torch.io.interop import extended_forest_from_arrays
from isoforest_tpu_torch.ops import ext_dense, ext_path, ext_walk
from isoforest_tpu_torch.ops.traversal import extended_path_lengths
from isoforest_tpu_torch.testing import finite_rows, random_extended_forest, rows
from isoforest_tpu_torch.utils.math import avg_path_length as port_c
from isoforest_tpu_torch.utils.math import fma_f32

FIXTURE = pathlib.Path(__file__).parent / "resources" / "torch_port" / "mammography_eif" / "model"
ALL_SIZES = np.arange(0, 300)


def sizes_with_equal_c() -> np.ndarray:
    """Leaf sizes whose c(n) the two packages compute bit for bit."""
    return ALL_SIZES[port_c(ALL_SIZES).numpy() == np.asarray(jax_c(ALL_SIZES))]


def quantized_rows(rng, n: int, features: int) -> np.ndarray:
    """TestQuantizedTieRouting's recipe: integers 0..3."""
    return rng.integers(0, 4, size=(n, features)).astype(np.float32)


def _port_dense(arrays, X) -> np.ndarray:
    forest = extended_forest_from_arrays(*arrays, device="cpu")
    return ext_dense.path_lengths_ext_dense(torch.from_numpy(X), ext_dense.hyperplane_tables(forest)).numpy()


def test_sparse_split_is_the_jax_packages():
    assert ext_dense.SPARSE_K_MAX == _SPARSE_K_MAX == 32


@pytest.mark.parametrize(
    "k,features,make_rows",
    [
        (1, 5, finite_rows),
        (6, 6, finite_rows),
        (6, 6, quantized_rows),
        (16, 16, quantized_rows),
        (17, 20, quantized_rows),
        (32, 36, finite_rows),
        (33, 40, finite_rows),
        (40, 40, quantized_rows),
    ],
)
def test_matches_jax_pallas_kernel_bitwise(k, features, make_rows):
    """K4 (k <= 32) and K5 (k > 32) against their Pallas kernels: 8 trees,
    intercepts drawn from the rows, so exact ties occur."""
    rng = np.random.default_rng(1000 + 10 * k + features)
    X = make_rows(rng, 1025, features)
    arrays = random_extended_forest(rng, 8, 4, features, k, sizes=sizes_with_equal_c(), intercepts=X[:32])
    forest = extended_forest_from_arrays(*arrays, device="cpu")
    tables = ext_dense.hyperplane_tables(forest)
    expected = ext_path.PathRecords if k <= 32 else ext_dense.DenseHyperplaneTables
    assert isinstance(tables, expected)
    got = ext_dense.path_lengths_ext_dense(torch.from_numpy(X), tables).numpy()
    want = np.asarray(jax_pallas(JaxForest(*arrays), X, interpret=True))
    np.testing.assert_array_equal(got, want)
    if k <= 32:  # the every-slot plain version, the kernel's reference on the card
        every_slot = ext_dense.ext_sparse_mean_plain(torch.from_numpy(X), ext_dense.sparse_hyperplane_tables(forest))
        np.testing.assert_array_equal(every_slot.numpy(), want)


def test_fixture_slice_matches_jax_pallas_kernel(mammography):
    """16 trees of the JAX-written mammography EIF (k = 6, tie-heavy),
    2,048 rows."""
    X = np.ascontiguousarray(mammography[0][:2048])
    jm = JaxModel.load(str(FIXTURE))
    arrays = tuple(np.asarray(a)[:16] for a in jm.forest)
    want = np.asarray(jax_pallas(JaxForest(*arrays), X, interpret=True))
    np.testing.assert_allclose(_port_dense(arrays, X), want, rtol=0, atol=2e-6)


@pytest.mark.parametrize("k,features", [(6, 7), (40, 40)])
def test_nonfinite_rows_route_like_the_gather_walk(k, features):
    """NaN goes left and +-inf count as numbers at the node's own
    coordinates; an unused coordinate adds x[0] * 0 (NaN on a non-finite
    x[0]), as in the gather walk."""
    rng = np.random.default_rng(40 + k)
    X = rows(rng, 600, features)
    arrays = random_extended_forest(rng, 7, 4, features, k, unused_p=0.4)
    got = _port_dense(arrays, X)
    np.testing.assert_allclose(got, np.asarray(jax_gather(JaxForest(*arrays), X)), rtol=0, atol=1e-5)
    wt = ext_walk.walk_tables_extended(extended_forest_from_arrays(*arrays, device="cpu"))
    if k > ext_walk.PAIRED_MAX_K:  # same dot order as the walk: same routing
        walk = ext_walk.path_lengths_ext_walk(torch.from_numpy(X), wt).numpy()
        np.testing.assert_allclose(got, walk, rtol=0, atol=1e-5)


def all_coordinate_dots(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``acc = fma(x[:, f], w[f], acc)`` from 0 over every coordinate of the
    dense rows, ``+0.0`` weights included: the dense-table kernel's product
    on rows without NaN or +-inf."""
    acc = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.float32)
    for f in range(w.shape[0]):
        acc = fma_f32(x[:, f : f + 1], w[f], acc)
    return acc


@pytest.mark.parametrize("k,features", [(33, 40), (40, 47), (274, 274)])
def test_all_coordinate_dots_route_like_the_skipping_form(k, features):
    """On finite rows the dense-table kernel's product over every coordinate
    of the dense row (+0.0 weights included) gives path lengths bit for bit
    equal to the plain version's chain over each node's own coordinates, on
    tie-heavy rows (integers 0..3, intercepts drawn from them) where dot ==
    offset is common (16 distinct rows, repeated), and with nodes that have
    unused and absent coordinates."""
    rng = np.random.default_rng(3000 + k)
    X = quantized_rows(rng, 16, features)[rng.integers(0, 16, 512)]
    arrays = random_extended_forest(rng, 4, 4, features, k, intercepts=X[:32], unused_p=0.3)
    tables = ext_dense.dense_hyperplane_table(extended_forest_from_arrays(*arrays, device="cpu"))
    m_int = (tables.value.shape[1] + 1) // 2 - 1
    Xt = torch.from_numpy(X)
    x = Xt[:, : tables.weight.shape[1]]
    kinds = tables.kind[:, :m_int]
    assert ((kinds & ext_dense.KIND_ABSENT) != 0).any() and ((kinds & ext_dense.KIND_UNUSED) != 0).any()
    ties = 0
    for t in range(tables.value.shape[0]):
        w, kind = tables.weight[t, :, :m_int], tables.kind[t, :m_int]
        dense, skipping = all_coordinate_dots(x, w), ext_dense.skipping_dots(x, w, kind)
        internal = kind > 0
        ties += int(((skipping == tables.value[t, :m_int]) & internal).sum())
        np.testing.assert_array_equal((dense >= tables.value[t, :m_int])[:, internal].numpy(),
                                      (skipping >= tables.value[t, :m_int])[:, internal].numpy())
    assert ties > 100
    walk_dense = ext_dense._walk_bits(Xt, lambda t: all_coordinate_dots(x, tables.weight[t, :, :m_int]),
                                      tables.value, tables.kind)
    assert torch.equal(walk_dense, ext_dense.ext_dense_mean_plain(Xt, tables))


@pytest.mark.parametrize("k,features", [(33, 40), (274, 274)])
def test_tile_of_finite_and_nonfinite_rows_routes_like_the_gather_walk(k, features):
    """One tile of rows, a few with NaN or +-inf at coordinates some nodes
    leave absent: those rows route like the gather walk (port and JAX), the
    finite rows beside them do not move."""
    rng = np.random.default_rng(4000 + k)
    X = finite_rows(rng, 128, features)
    arrays = random_extended_forest(rng, 5, 5, features, k, unused_p=0.3)
    forest = extended_forest_from_arrays(*arrays, device="cpu")
    tables = ext_dense.dense_hyperplane_table(forest)
    finite = ext_dense.ext_dense_mean_plain(torch.from_numpy(X), tables)
    X[3, 0], X[40, features - 1], X[77, features // 2], X[100, 1] = np.nan, np.inf, -np.inf, np.nan
    Xt = torch.from_numpy(X)
    got = ext_dense.ext_dense_mean_plain(Xt, tables)
    moved = (got != finite).nonzero()[:, 0].tolist()
    assert set(moved) <= {3, 40, 77, 100} and moved
    torch.testing.assert_close(got, extended_path_lengths(forest, Xt), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_gather(JaxForest(*arrays), X)), rtol=0, atol=1e-5)


@pytest.mark.parametrize("k,features,unused_p", [(33, 40, 0.0), (40, 40, 0.3), (274, 274, 0.2)])
def test_dense_table_is_the_jax_table_permuted(k, features, unused_p):
    """The slot-minor heap-order weight table holds the JAX package's
    ``dense_hyperplane_table`` (node-major, level-concat order): the same
    weight at every internal-capable slot and coordinate, zeros elsewhere."""
    rng = np.random.default_rng(5000 + k)
    arrays = random_extended_forest(rng, 3, 4, features, k, unused_p=unused_p)
    jf = JaxForest(*arrays)
    tables = ext_dense.dense_hyperplane_table(extended_forest_from_arrays(*arrays, device="cpu"))
    t_n, width, m4 = tables.weight.shape
    m = jf.indices.shape[1]
    m_int = (m + 1) // 2 - 1
    want = np.asarray(jax_dense_table(jf, 128, 384))  # [T, m_pad, f_pad], concat order
    position = np.argsort(np.asarray(_concat_order(m)))  # table slot of each heap slot
    got = tables.weight.numpy()
    assert width == features and m4 == (m_int + 3) // 4 * 4
    np.testing.assert_array_equal(got[:, :, :m_int], want[:, position[:m_int], :width].transpose(0, 2, 1))
    assert not got[:, :, m_int:].any() and not want[:, :, width:].any()
    assert not want[:, position[m_int:]].any()  # leaf-level slots carry no weights
    node_major = tables.node_weight.numpy()  # the same weights a node a row, padded to 4 features
    assert node_major.shape == (t_n, m_int, (width + 3) // 4 * 4)
    np.testing.assert_array_equal(node_major[:, :, :width].view(np.int32),
                                  got[:, :, :m_int].transpose(0, 2, 1).view(np.int32))
    assert not node_major[:, :, width:].view(np.int32).any()


def _one_node_forest(coords, weights, offset, k, sizes=(2, 50)):
    """One tree of height 1: the root's hyperplane, leaves of ``sizes``."""
    indices = np.full((1, 3, k), -1, np.int32)
    w = np.zeros((1, 3, k), np.float32)
    indices[0, 0, : len(coords)] = coords
    w[0, 0, : len(coords)] = weights
    off = np.zeros((1, 3), np.float32)
    off[0, 0] = offset
    num_instances = np.array([[-1, *sizes]], np.int32)
    return indices, w, off, num_instances


def test_duplicate_coordinates_merge_like_the_reference():
    """A coordinate listed twice adds its weights first (np.add.at, the
    reference's densify), in both kernels' tables, and routes as the
    reference's kernels route it. The slot the merge frees is skipped (index
    -1), not an unused coordinate: a non-finite x[0] leaves the dot alone in
    both kernels, as in the gather walk."""
    eq = sizes_with_equal_c()
    arrays = _one_node_forest([3, 1, 3], [0.5, -0.25, 0.75], 0.0, 3, sizes=(eq[2], eq[40]))
    forest = extended_forest_from_arrays(*arrays, device="cpu")
    sparse = ext_dense.sparse_hyperplane_tables(forest)
    np.testing.assert_array_equal(sparse.index[0, 0].numpy(), [1, 3, -1])
    np.testing.assert_array_equal(sparse.weight[0, 0].numpy(), np.float32([-0.25, 1.25, 0.0]))
    assert sparse.min_features == 4
    dense = ext_dense.dense_hyperplane_table(forest)
    np.testing.assert_array_equal(dense.weight[0, :, 0].numpy(), np.float32([0, -0.25, 0, 1.25]))
    assert dense.kind[0, 0] == ext_dense.KIND_INTERNAL | ext_dense.KIND_ABSENT  # coordinates 0 and 2
    records = ext_dense.sparse_path_records(forest)
    assert records.min_features == 4
    rng = np.random.default_rng(3)
    X = finite_rows(rng, 1024, 4)
    want = np.asarray(jax_pallas(JaxForest(*arrays), X, interpret=True))
    Xt = torch.from_numpy(X)
    np.testing.assert_array_equal(ext_dense.ext_sparse_mean(Xt, records).numpy(), want)
    np.testing.assert_array_equal(ext_dense.ext_sparse_mean_plain(Xt, sparse).numpy(), want)
    np.testing.assert_array_equal(ext_dense.ext_dense_mean(Xt, dense).numpy(), want)
    X[: len(X) // 2, 0] = np.resize(np.float32([np.nan, np.inf, -np.inf]), len(X) // 2)
    Xt = torch.from_numpy(X)
    got = ext_dense.ext_sparse_mean(Xt, records).numpy()
    np.testing.assert_array_equal(got, ext_dense.ext_sparse_mean_plain(Xt, sparse).numpy())
    np.testing.assert_array_equal(got, ext_dense.ext_dense_mean(Xt, dense).numpy())
    np.testing.assert_array_equal(got, want)  # x[0] is not a coordinate
    np.testing.assert_allclose(got, np.asarray(jax_gather(JaxForest(*arrays), X)), rtol=0, atol=1e-5)


def test_dense_table_marks_zero_weights_and_unused_coordinates():
    """A present coordinate whose weights cancel is stored as -0.0 (it
    still reads x[f], so an infinite x[f] makes the dot NaN and the row goes
    left); an absent one is +0.0 and skipped; a node with an unused
    coordinate has the kind bit KIND_UNUSED and adds x[0] * 0."""
    arrays = _one_node_forest([2, 2, 1], [0.5, -0.5, 1.0], -5.0, 4)
    forest = extended_forest_from_arrays(*arrays, device="cpu")
    dense = ext_dense.dense_hyperplane_table(forest)
    bits = dense.weight[0, :, 0].view(torch.int32).numpy()
    assert bits[0] == 0 and bits[2] == np.float32(-0.0).view(np.int32)
    assert dense.kind[0, 0] == ext_dense.KIND_INTERNAL | ext_dense.KIND_UNUSED | ext_dense.KIND_ABSENT
    X = np.array([[0, 0, 0], [0, 0, np.inf], [np.inf, 0, 0], [0, 1, 0]], np.float32)
    left, right = np.float32(1 + float(port_c(2))), np.float32(1 + float(port_c(50)))
    want = np.array([right, left, left, right], np.float32)
    np.testing.assert_array_equal(ext_dense.ext_dense_mean(torch.from_numpy(X), dense).numpy(), want)
    sparse = ext_dense.sparse_hyperplane_tables(forest)
    # used, then the unused coordinate's x[0] * 0, then the merged-away slot last
    np.testing.assert_array_equal(sparse.index[0, 0].numpy(), [1, 2, 0, -1])
    np.testing.assert_array_equal(ext_dense.ext_sparse_mean_plain(torch.from_numpy(X), sparse).numpy(), want)
    records = ext_dense.sparse_path_records(forest)
    np.testing.assert_array_equal(ext_dense.ext_sparse_mean(torch.from_numpy(X), records).numpy(), want)


def test_height_fence():
    rng = np.random.default_rng(8)
    X = torch.from_numpy(finite_rows(rng, 64, 4))
    at_fence = extended_forest_from_arrays(*random_extended_forest(rng, 2, 10, 4, 2, 0.3), device="cpu")
    got = ext_dense.path_lengths_ext_dense(X, ext_dense.hyperplane_tables(at_fence))
    torch.testing.assert_close(got, extended_path_lengths(at_fence, X), rtol=0, atol=1e-5)
    above = extended_forest_from_arrays(*random_extended_forest(rng, 2, 11, 4, 2, 0.3), device="cpu")
    with pytest.raises(ValueError, match="DENSE_MAX_HEIGHT=10"):
        ext_dense.ext_sparse_mean(X, ext_dense.sparse_path_records(above))
    with pytest.raises(ValueError, match="DENSE_MAX_HEIGHT=10"):
        ext_dense.ext_dense_mean(X, ext_dense.dense_hyperplane_table(above))


@pytest.mark.parametrize("height", range(0, 11))
def test_dense_top_levels_at_every_height(height):
    """The dense-table kernel's form at each height the dense strategy
    serves: the fully dense form (``top`` = the height) where no dense top
    the kernel has lies below the height, and for tables wider than the
    resident tile; else ``DENSE_TOP`` levels, 2 at height 3."""
    for width in (1, 33, 274, ext_dense.PATH_MAX_WIDTH):
        top = ext_dense.dense_top_levels(height, width)
        assert top == (height if height <= 2 else min(ext_dense.DENSE_TOP, height - 1))
        assert top == height or (top in ext_dense.DENSE_TOPS and top < height)
    assert ext_dense.dense_top_levels(height, ext_dense.PATH_MAX_WIDTH + 1) == height


def test_dense_top_bounds_are_the_kernels():
    """The host's bounds of the dense-top form are the CUDA source's."""
    src = (pathlib.Path(ext_dense.__file__).parent.parent / "csrc" / "ext_gemm.cu").read_text()
    const = {name: int(v) for name, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    const.update({name: int(v) for name, v in re.findall(r"(kMinTop|kMaxTop) = (\d+)", src)})
    assert ext_dense.PATH_MAX_WIDTH == const["kPathMaxWidth"]
    assert ext_dense.DENSE_TOPS == tuple(range(const["kMinTop"], const["kMaxTop"] + 1))
    assert ext_dense.DENSE_TOP in ext_dense.DENSE_TOPS


def test_plain_versions_on_cpu_count_no_launch():
    rng = np.random.default_rng(9)
    forest = extended_forest_from_arrays(*random_extended_forest(rng, 4, 4, 3, 2), device="cpu")
    X = torch.from_numpy(finite_rows(rng, 33, 3))
    before = dict(ext_path.launches)
    got = ext_dense.ext_sparse_mean(X, ext_dense.sparse_path_records(forest))
    assert ext_path.launches == before
    assert torch.equal(got, ext_dense.ext_sparse_mean_plain(X, ext_dense.sparse_hyperplane_tables(forest)))
    tables = ext_dense.dense_hyperplane_table(forest)
    before, by_top = ext_dense.ext_dense_mean.launches, dict(ext_dense.ext_dense_mean.launches_by_top)
    got = ext_dense.ext_dense_mean(X, tables)
    assert ext_dense.ext_dense_mean.launches == before and ext_dense.ext_dense_mean.launches_by_top == by_top
    assert torch.equal(got, ext_dense.ext_dense_mean_plain(X, tables))


def test_wrappers_check_inputs():
    rng = np.random.default_rng(10)
    forest = extended_forest_from_arrays(*random_extended_forest(rng, 3, 3, 3, 2), device="cpu")
    sparse = ext_dense.sparse_path_records(forest)
    dense = ext_dense.dense_hyperplane_table(forest)
    with pytest.raises(ValueError, match="contiguous float32"):
        ext_dense.ext_sparse_mean(torch.zeros(4, 3).t(), sparse)
    with pytest.raises(ValueError, match="ext_sparse_mean table 'records'"):
        ext_dense.ext_sparse_mean(torch.zeros(4, 3), sparse._replace(records=sparse.records.long()))
    with pytest.raises(ValueError, match="ext_sparse_mean table 'records' has 4 words a record"):
        ext_dense.ext_sparse_mean(torch.zeros(4, 3), sparse._replace(records=sparse.records[:, :4].contiguous()))
    with pytest.raises(ValueError, match="EIF dense table 'value'"):
        ext_dense.ext_dense_mean(torch.zeros(4, 3), dense._replace(value=dense.value.double()))
    with pytest.raises(ValueError, match="X has 2 features, but the hyperplane tables span 3"):
        ext_dense.ext_dense_mean(torch.zeros(4, 2), dense)
    with pytest.raises(ValueError, match=f"X has 1 features, but the ext_sparse_mean tables read feature "
                                         f"{sparse.min_features - 1}"):
        ext_dense.ext_sparse_mean(torch.zeros(4, 1), sparse)
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        ext_dense.ext_dense_mean(torch.zeros(4, 3, device="meta"), type(dense)(*(t.to("meta") for t in dense)))


@pytest.mark.parametrize("k,height", [(6, 0), (6, 1), (3, 2)])
def test_low_trees_match_jax_pallas_kernel_bitwise(k, height):
    """Heights 0 to 2, root-leaf trees among them (tree 0), on tie-heavy
    rows: the plain version against the Pallas kernel bit for bit."""
    rng = np.random.default_rng(1500 + 10 * k + height)
    X = quantized_rows(rng, 300, 6)
    arrays = random_extended_forest(rng, 8, height, 6, k, sizes=sizes_with_equal_c(), intercepts=X[:32])
    got = _port_dense(arrays, X)
    np.testing.assert_array_equal(got, np.asarray(jax_pallas(JaxForest(*arrays), X, interpret=True)))


@pytest.mark.parametrize(
    "k,features,height,data",
    [
        (6, 6, 8, "ties"),
        (6, 7, 5, "nonfinite"),
        (16, 16, 4, "ties"),
        (17, 17, 4, "nonfinite"),
        (32, 40, 3, "ties"),
        (6, 6, 0, "nonfinite"),
        (1, 300, 6, "nonfinite"),
    ],
)
def test_path_only_walk_equals_every_slot_walk_bitwise(k, features, height, data):
    """Evaluating only the slots on a row's path (the sparse kernel) gives
    the every-slot plain version's mean bit for bit: ties, NaN and +-inf
    rows, the k = 16/17 widths, h = 0, root-leaf trees, u16 indices."""
    rng = np.random.default_rng(6000 + 10 * k + height)
    X = quantized_rows(rng, 700, features) if data == "ties" else rows(rng, 700, features)
    arrays = random_extended_forest(rng, 9, height, features, k, intercepts=X[:32], unused_p=0.3)
    forest = extended_forest_from_arrays(*arrays, device="cpu")
    Xt = torch.from_numpy(X)
    path_only = ext_dense.ext_sparse_mean(Xt, ext_dense.sparse_path_records(forest))
    assert torch.equal(path_only, ext_dense.ext_sparse_mean_plain(Xt, ext_dense.sparse_hyperplane_tables(forest)))


def test_path_only_walk_skips_merged_coordinates():
    """A merge leaves fewer terms in the record: the path-only walk stops
    where the every-slot walk meets -1, on rows whose x[0] is not finite."""
    eq = sizes_with_equal_c()
    arrays = _one_node_forest([3, 1, 3], [0.5, -0.25, 0.75], 0.0, 3, sizes=(eq[2], eq[40]))
    forest = extended_forest_from_arrays(*arrays, device="cpu")
    records = ext_dense.sparse_path_records(forest)
    offset, left, right, terms, index, weight = ext_path.record_fields(records)
    assert terms.tolist() == [2] and index[0, :2].tolist() == [1, 3]
    X = finite_rows(np.random.default_rng(5), 256, 4)
    X[::2, 0] = np.resize(np.float32([np.nan, np.inf, -np.inf]), 128)
    Xt = torch.from_numpy(X)
    every_slot = ext_dense.ext_sparse_mean_plain(Xt, ext_dense.sparse_hyperplane_tables(forest))
    assert torch.equal(ext_dense.ext_sparse_mean(Xt, records), every_slot)


@pytest.mark.parametrize("k,features,unused_p", [(6, 6, 0.3), (32, 40, 0.0), (12, 1000, 0.5)])
def test_sparse_records_hold_the_jax_sparse_tables(k, features, unused_p):
    """The sparse kernel's records hold the JAX package's
    ``sparse_hyperplane_tables`` (``[T, k, M_pad]``, level-concat order)
    packed: at every internal node the record's terms give each coordinate
    its merged weight (duplicates added as ``np.add.at`` adds them) and one
    ``x[0] * 0`` term per unused coordinate, in ascending order."""
    rng = np.random.default_rng(7000 + k)
    arrays = random_extended_forest(rng, 3, 4, features, k, unused_p=unused_p)
    arrays[0][1, 0, :2] = arrays[0][1, 0, 1]  # one duplicate coordinate
    jf = JaxForest(*arrays)
    m = arrays[0].shape[1]
    idx, w = (np.asarray(a) for a in jax_sparse_tables(jf, 128))
    position = np.argsort(np.asarray(_concat_order(m)))  # table slot of each heap slot
    idx, w = idx[:, :, position].transpose(0, 2, 1), w[:, :, position].transpose(0, 2, 1)
    records = ext_dense.sparse_path_records(extended_forest_from_arrays(*arrays, device="cpu"))
    _, _, _, terms, index, weight = (a.numpy() for a in ext_path.record_fields(records))
    tt, ss = np.nonzero(arrays[0][..., 0] >= 0)
    assert len(terms) == len(tt) and records.chunk_terms == 3
    for r, (t, slot) in enumerate(zip(tt, ss)):
        coords = idx[t, slot]
        want = np.zeros(features, np.float32)
        np.add.at(want, coords[coords >= 0], w[t, slot][coords >= 0])
        n_used = len(np.unique(coords[coords >= 0]))
        assert terms[r] == n_used + (coords < 0).sum()
        got = np.zeros(features, np.float32)
        got[index[r, :n_used]] = weight[r, :n_used]
        np.testing.assert_array_equal(got, want)
        assert (np.diff(index[r, :n_used]) > 0).all()
        assert not index[r, n_used : terms[r]].any() and not weight[r, n_used : terms[r]].any()
