"""Gather-free dense level walk of an extended forest: the port of
``isoforest_tpu/ops/pallas_traversal.py``'s two EIF kernels,
``_extended_pallas_sparse`` (k <= 32) and ``_extended_pallas_dense``.

Host-side table builders, the wrappers of the two CUDA kernels
(``ext_sparse_mean`` of ``csrc/path_walk.cu`` on the sparse hyperplanes'
path records, ``csrc/ext_gemm.cu`` on the dense table) and their plain
PyTorch versions. Both reference plain versions (:func:`ext_sparse_mean_plain`
on the heap tables of :func:`sparse_hyperplane_tables`, which only it
reads, and :func:`ext_dense_mean_plain`) evaluate every internal slot's
hyperplane test, follow each row's go-right bits to its exit leaf and
accumulate ``pl / T`` tree by tree, as the Pallas kernels' source does
(``pallas_traversal.py:239``). The sparse kernel evaluates only the slots
on each row's path, from the compact records of :mod:`.ext_path` (built by
:func:`sparse_path_records`), with the same dots: only the bits on the path
are read, so the result is the same bit for bit, and the kernel is held to
the every-slot plain version on the card. The dense-table kernel computes
every slot of a tree's top levels as a product and, below them, only the
node each row's path reaches (:func:`dense_top_levels`), and is held to
its every-slot plain version the same way.

Each dot is ``acc = fma(x[f], w, acc)`` from 0 over the node's coordinates
in ascending feature order, duplicates merged as ``np.add.at`` merges them:
the FMA chain XLA:CPU makes of the reference's ``X @ W`` (measured), so on
finite rows the dots are the reference's bit for bit. Rows with NaN or
+-inf route like the gather walk (only the node's coordinates, plus
``x[0] * 0`` for each unused one), not like the product, which would make
such a row NaN at every slot. The dense-table kernel takes every
coordinate of the dense row on rows without NaN or +-inf, where an absent
coordinate's ``fma(x, +0.0, acc)`` changes at most the sign of a zero
(``csrc/ext_gemm.cu`` gives the argument); its plain version takes only
each node's own coordinates on every row, so holding the kernel to it on
the card checks that argument. The plain versions compute each FMA with
:func:`~isoforest_tpu_torch.utils.math.fma_f32`.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..utils.math import fma_f32, height_of
from . import _build, ext_path
from .dense import DENSE_MAX_HEIGHT
from .ext_growth import ExtendedForest
from .scoring_layout import pack_extended

# Sparse/dense split of pallas_traversal.py:300: hyperplanes of up to this
# many coordinates take the sparse kernel, wider ones the dense table.
SPARSE_K_MAX = 32

_P = ctypes.c_void_p
_I = ctypes.c_int
_DENSE_SIGNATURES = {"ext_dense_mean": (_P, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P)}

# The dense-table kernel's two forms (csrc/ext_gemm.cu). Its dense-top form
# computes the top DENSE_TOP levels of a tree as a product (2 for a tree of
# height 3) and evaluates only each row's node below them: measured on an
# H100, 3 is the fastest of the depths it has at every height from 4 to 10
# (PERF.md §6, tools/torch_port_kernel_paths.py). Trees of height <= 2 have
# no level below a top of 2, and rows wider than PATH_MAX_WIDTH (the
# kernel's kPathMaxWidth) do not fit in shared memory: both take the fully
# dense form, which computes every internal slot.
DENSE_TOP = 3
PATH_MAX_WIDTH = 384
DENSE_TOPS = (2, 3, 4, 5)  # the dense-top depths the kernel has (kMinTop .. kMaxTop)

# Bits of the dense table's ``kind`` (csrc/ext_gemm.cu): an internal node;
# one with unused coordinates (the gather walk's x[0] * 0 term); one with an
# absent coordinate below the table's width (+0.0 weight).
KIND_INTERNAL, KIND_UNUSED, KIND_ABSENT = 1, 2, 4


class SparseHyperplaneTables(NamedTuple):
    """The sparse hyperplanes in heap order, read by the every-slot plain
    version alone: ``value`` f32 [T, M]: offset at internal slots,
    ``depth + c(n)`` at leaves, 0 at holes; ``kind`` i32 [T, M]: 1 at
    internal slots, else 0; ``index`` i32 / ``weight`` f32 [T, 2^h - 1, k]:
    each internal node's coordinates ascending, duplicates merged, then
    ``(0, 0.0)`` for each unused one (the gather walk's ``x[0] * 0``), then
    ``(-1, 0.0)`` for each coordinate a merge removed, where the node's
    terms end; ``min_features``, ``1 + max(index)``: the narrowest row the
    tables read."""

    value: torch.Tensor
    kind: torch.Tensor
    index: torch.Tensor
    weight: torch.Tensor
    min_features: int


class DenseHyperplaneTables(NamedTuple):
    """``value`` as for the sparse tables; ``kind`` i32 [T, M], the bits
    ``KIND_INTERNAL | KIND_UNUSED | KIND_ABSENT`` of each internal node, 0
    elsewhere; ``weight`` f32 [T, W, M4], slot-minor, with ``W = 1 +
    max(index)`` and ``M4`` the ``2^h - 1`` internal-capable slots rounded
    up to 4: the merged weight of each present coordinate (``-0.0`` where it
    is zero), ``+0.0`` where absent and in the padding; ``node_weight`` f32
    [T, 2^h - 1, W4], the same weights node-major, each node's row padded
    with ``+0.0`` to ``W4``, ``W`` rounded up to 4 (the dense-table kernel's
    path walk reads a node's row in 16-byte loads)."""

    value: torch.Tensor
    kind: torch.Tensor
    weight: torch.Tensor
    node_weight: torch.Tensor


def _common(forest: ExtendedForest):
    """CPU ``(value, kind, indices, weights)``, the last two cut to the
    internal-capable slots and with coordinates of non-internal slots unused."""
    layout = pack_extended(forest)
    value = layout.value.detach().to("cpu", torch.float32)
    m_int = (forest.max_nodes + 1) // 2 - 1
    indices = forest.indices.detach().to("cpu", torch.int32).numpy()[:, :m_int]
    weights = forest.weights.detach().to("cpu", torch.float32).numpy()[:, :m_int]
    internal = indices[..., 0] >= 0
    indices = np.where(internal[..., None], indices, -1)
    kind = np.zeros(value.shape, np.int32)
    kind[:, :m_int] = np.where(internal, 1, 0)
    return value, kind, indices, weights


def _sparse_heap(forest: ExtendedForest):
    """CPU ``(value, kind, index, weight, terms)`` of the sparse hyperplanes
    in heap order (:class:`SparseHyperplaneTables`); ``terms`` i32 [T,
    2^h - 1]: each node's terms, those before its first -1."""
    value, kind, indices, weights = _common(forest)
    t_n, m_int, k = indices.shape
    absent = np.iinfo(np.int64).max
    key = np.where(indices >= 0, indices.astype(np.int64), absent)
    order = np.argsort(key, axis=2, kind="stable")  # equal coordinates keep their order
    key = np.take_along_axis(key, order, axis=2)
    w = np.take_along_axis(weights, order, axis=2).copy()
    keep = np.ones(key.shape, bool)
    start = np.zeros((t_n, m_int), np.int64)
    for q in range(1, k):
        dup = (key[..., q] == key[..., q - 1]) & (key[..., q] != absent)
        start = np.where(dup, start, q)
        run = np.take_along_axis(w, start[..., None], axis=2)[..., 0]
        np.put_along_axis(w, start[..., None], np.where(dup, run + w[..., q], run)[..., None], axis=2)
        keep[..., q] = ~dup
    key = np.where(keep, key, absent)
    order = np.argsort(key, axis=2, kind="stable")
    key = np.take_along_axis(key, order, axis=2)
    w = np.take_along_axis(w, order, axis=2)
    used = key != absent
    # used coordinates come first; then one x[0] * 0 per unused coordinate
    terms = used.sum(axis=2) + (indices < 0).sum(axis=2)
    index = np.where(used, key, np.where(np.arange(k) < terms[..., None], 0, -1)).astype(np.int32)
    weight = np.where(used, w, np.float32(0)).astype(np.float32)
    return value, kind, index, weight, terms.astype(np.int32)


def sparse_hyperplane_tables(forest: ExtendedForest) -> SparseHyperplaneTables:
    """The every-slot plain version's heap tables (``sparse_hyperplane_tables``
    and ``extended_common_tables``, ``pallas_traversal.py:397-427``, in heap
    order), built on the CPU and moved to the forest's device."""
    value, kind, index, weight, _ = _sparse_heap(forest)
    dev = forest.device
    return SparseHyperplaneTables(
        value=value.contiguous().to(dev),
        kind=torch.from_numpy(kind).to(dev),
        index=torch.from_numpy(index).to(dev),
        weight=torch.from_numpy(weight).to(dev),
        min_features=int(index.max(initial=0)) + 1,
    )


def sparse_path_records(forest: ExtendedForest) -> ext_path.PathRecords:
    """The sparse kernel's table: the same hyperplanes as
    :func:`sparse_hyperplane_tables`, one record per internal node with its
    terms, built on the CPU and moved to the forest's device."""
    value, kind, index, weight, terms = _sparse_heap(forest)
    t_n, m_int, k = index.shape
    heap_index = np.zeros(value.shape + (k,), np.int32)
    heap_index[:, :m_int] = index
    heap_weight = np.zeros(value.shape + (k,), np.float32)
    heap_weight[:, :m_int] = weight
    heap_terms = np.zeros(value.shape, np.int32)
    heap_terms[:, :m_int] = terms
    return ext_path.build_path_records(kind == 1, value.numpy(), value.numpy(), heap_index, heap_weight, heap_terms,
                                       height_of(value.shape[1]), forest.device)


def dense_hyperplane_table(forest: ExtendedForest) -> DenseHyperplaneTables:
    """The dense kernel's tables (``dense_hyperplane_table``,
    ``pallas_traversal.py:430``, in heap order and slot-minor; duplicate
    coordinates accumulate as ``np.add.at`` adds them), built on the CPU and
    moved to the forest's device."""
    value, kind, indices, weights = _common(forest)
    t_n, m_int, _ = indices.shape
    width = max(int(indices.max(initial=-1)) + 1, 1)
    W = np.zeros((t_n, m_int, width), np.float32)
    present = np.zeros(W.shape, bool)
    t_ix, m_ix, k_ix = np.nonzero(indices >= 0)
    f_ix = indices[t_ix, m_ix, k_ix]
    np.add.at(W, (t_ix, m_ix, f_ix), weights[t_ix, m_ix, k_ix])
    present[t_ix, m_ix, f_ix] = True
    W = np.where(present & (W == 0), np.float32(-0.0), W)
    internal = kind[:, :m_int] == 1
    bits = (KIND_INTERNAL + KIND_UNUSED * (indices < 0).any(axis=2) + KIND_ABSENT * ~present.all(axis=2))
    kind[:, :m_int] = np.where(internal, bits, 0)
    slot_minor = np.zeros((t_n, width, (m_int + 3) // 4 * 4), np.float32)
    slot_minor[:, :, :m_int] = W.transpose(0, 2, 1)
    node_major = np.zeros((t_n, m_int, (width + 3) // 4 * 4), np.float32)
    node_major[:, :, :width] = W
    dev = forest.device
    return DenseHyperplaneTables(
        value=value.contiguous().to(dev),
        kind=torch.from_numpy(kind).to(dev),
        weight=torch.from_numpy(slot_minor).to(dev),
        node_weight=torch.from_numpy(node_major).to(dev),
    )


def _walk_bits(X: torch.Tensor, dots_fn, value: torch.Tensor, kind: torch.Tensor) -> torch.Tensor:
    """``sum_t pl_t / T`` in tree order, where ``dots_fn(t)`` gives tree
    t's ``[N, 2^h - 1]`` hyperplane dots and each row follows its go-right
    bits from the root to its exit leaf."""
    n = X.shape[0]
    t_count, m = value.shape
    h = height_of(m)
    m_int = (m + 1) // 2 - 1
    t_real = torch.tensor(float(t_count), dtype=torch.float32, device=X.device)
    acc = torch.zeros(n, dtype=torch.float32, device=X.device)
    for t in range(t_count):
        node = torch.zeros(n, dtype=torch.long, device=X.device)
        if m_int:
            right = dots_fn(t) >= value[t, :m_int]
            for _ in range(h):
                inside = kind[t][node] > 0
                b = right.gather(1, node.clamp(max=m_int - 1)[:, None])[:, 0]
                node = torch.where(inside, 2 * node + 1 + b.long(), node)
        acc = acc + value[t][node] / t_real
    return acc


def ext_sparse_mean_plain(X: torch.Tensor, tables: SparseHyperplaneTables) -> torch.Tensor:
    """The sparse kernel's function in plain PyTorch."""

    def dots(t):
        acc = torch.zeros((X.shape[0], tables.index.shape[1]), dtype=torch.float32, device=X.device)
        for q in range(tables.index.shape[2]):
            index = tables.index[t, :, q]
            term = fma_f32(X[:, index.clamp(min=0).long()], tables.weight[t, :, q], acc)
            acc = torch.where(index >= 0, term, acc)
        return acc

    return _walk_bits(X, dots, tables.value, tables.kind)


def skipping_dots(x: torch.Tensor, w: torch.Tensor, kind: torch.Tensor) -> torch.Tensor:
    """``acc = fma(x[:, f], w[f, s], acc)`` from 0 over each node's own
    coordinates in ascending order (a ``+0.0`` weight is absent and
    skipped), then ``x[0] * 0`` at nodes with unused coordinates: ``x`` [N,
    W] by slot-minor ``w`` [W, S] gives [N, S]. The reference's chain,
    routing NaN and +-inf like the gather walk."""
    acc = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.float32, device=x.device)
    present = w.view(torch.int32) != 0
    for f in range(w.shape[0]):
        acc = torch.where(present[f], fma_f32(x[:, f : f + 1], w[f], acc), acc)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    return torch.where((kind & KIND_UNUSED) != 0, fma_f32(x[:, :1], zero, acc), acc)


def ext_dense_mean_plain(X: torch.Tensor, tables: DenseHyperplaneTables) -> torch.Tensor:
    """The dense kernel's function in plain PyTorch: every slot's
    :func:`skipping_dots`, then each row's path along its go-right bits."""
    x = X[:, : tables.weight.shape[1]]
    m_int = (tables.value.shape[1] + 1) // 2 - 1
    return _walk_bits(X, lambda t: skipping_dots(x, tables.weight[t, :, :m_int], tables.kind[t, :m_int]),
                      tables.value, tables.kind)


def ext_sparse_mean(X: torch.Tensor, records: ext_path.PathRecords) -> torch.Tensor:
    """Mean path length over trees from the sparse hyperplanes' records
    (:func:`sparse_path_records`), ``f32[N]``.

    On a CUDA tensor this launches ``ext_sparse_mean`` of
    ``csrc/path_walk.cu`` through :func:`.ext_path.launch`, which counts it
    in ``ext_path.launches["ext_sparse_mean"]``; on a CPU tensor it runs
    the same walk over the records in plain PyTorch
    (:func:`.ext_path.path_sum_plain`), which the tests hold bit for bit
    to :func:`ext_sparse_mean_plain`.
    """
    ext_path.check_records(X, records, "ext_sparse_mean")
    _check_height(records.height)
    if X.device.type == "cpu":
        return ext_path.path_sum_plain(X, records, paired=False, mean=True)
    return ext_path.launch("ext_sparse_mean", X, records)


def ext_dense_mean(X: torch.Tensor, tables: DenseHyperplaneTables) -> torch.Tensor:
    """Mean path length over trees from the dense hyperplane table, ``f32[N]``.

    On a CUDA tensor this launches ``ext_dense_mean`` of
    ``csrc/ext_gemm.cu`` in the form :func:`dense_top_levels` picks and
    counts the launch in ``ext_dense_mean.launches`` and, by the levels
    computed as a product, in ``ext_dense_mean.launches_by_top``; on a CPU
    tensor it runs :func:`ext_dense_mean_plain`.
    """
    t_count, m = tables.value.shape
    width = tables.weight.shape[1] if tables.weight.dim() == 3 else 0
    m_int = (m + 1) // 2 - 1
    _check_inputs(X, tables, {"weight": (t_count, width, (m_int + 3) // 4 * 4),
                              "node_weight": (t_count, m_int, (width + 3) // 4 * 4)}, width)
    _check_height(height_of(m))
    if X.device.type == "cpu":
        return ext_dense_mean_plain(X, tables)
    n, f = X.shape
    out = torch.empty(n, dtype=torch.float32, device=X.device)
    if n == 0:
        return out
    lib = _build.load("ext_gemm", _DENSE_SIGNATURES)
    h = height_of(m)
    top = dense_top_levels(h, width)
    err = lib.ext_dense_mean(
        X.data_ptr(), n, f, tables.value.data_ptr(), tables.kind.data_ptr(),
        tables.weight.data_ptr(), tables.node_weight.data_ptr(), width, t_count, h, top,
        out.data_ptr(), torch.cuda.current_stream(X.device).cuda_stream,
    )
    _build.check(err, "ext_dense_mean")
    ext_dense_mean.launches += 1
    ext_dense_mean.launches_by_top[top] = ext_dense_mean.launches_by_top.get(top, 0) + 1
    return out


ext_dense_mean.launches = 0
ext_dense_mean.launches_by_top = {}


def dense_top_levels(height: int, width: int) -> int:
    """Levels of a tree of ``height`` whose every slot the dense-table
    kernel computes as a product, at table width ``width``: ``height`` for
    the fully dense form, else a depth of ``DENSE_TOPS`` below ``height``,
    under which each row's dot is computed at the one node its path
    reaches."""
    top = min(DENSE_TOP, height - 1)
    return top if top in DENSE_TOPS and width <= PATH_MAX_WIDTH else height


def _check_inputs(X: torch.Tensor, tables: DenseHyperplaneTables, weight_shapes: dict, min_features: int) -> None:
    """``value`` and ``kind`` take ``[T, M]``, the weights ``weight_shapes``."""
    if X.dtype != torch.float32 or X.dim() != 2 or not X.is_contiguous():
        raise ValueError(f"X must be a contiguous float32 [N, F] tensor, got {X.dtype} {tuple(X.shape)}")
    if X.shape[1] < 1:
        raise ValueError("X needs at least one feature column")
    if X.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the EIF dense kernels run on 'cuda' or 'cpu' tensors, got {X.device}")
    plane = tables.value.shape
    for name, dtype, shape in (("value", torch.float32, plane), ("kind", torch.int32, plane),
                               *((name, torch.float32, tuple(shape)) for name, shape in weight_shapes.items())):
        a = getattr(tables, name)
        if a.device != X.device or a.dtype != dtype or a.shape != shape or not a.is_contiguous():
            raise ValueError(
                f"EIF dense table {name!r} must be a contiguous {dtype} {tuple(shape)} tensor "
                f"on {X.device}, got {a.dtype} {tuple(a.shape)} on {a.device}"
            )
    if X.shape[1] < min_features:
        raise ValueError(f"X has {X.shape[1]} features, but the hyperplane tables span {min_features}")
    if X.shape[0] >= 2**31:
        raise ValueError("the dense kernels take fewer than 2^31 rows")


def _check_height(h: int) -> None:
    """``strategy="dense"`` serves trees up to ``DENSE_MAX_HEIGHT``, with
    either kernel, so it takes the same forests whatever their k."""
    if h > DENSE_MAX_HEIGHT:
        raise ValueError(
            f"the dense kernels support trees of height <= DENSE_MAX_HEIGHT="
            f"{DENSE_MAX_HEIGHT} (the dense-table kernel keeps a row's go-right "
            f"bits in at most 32 words); this forest has height {h}: use strategy='walk'"
        )


def hyperplane_tables(forest: ExtendedForest):
    """The tables of the kernel that serves ``forest``: the sparse
    hyperplanes' records for ``k <= SPARSE_K_MAX``, the dense table above."""
    return sparse_path_records(forest) if forest.k <= SPARSE_K_MAX else dense_hyperplane_table(forest)


def path_lengths_ext_dense(X: torch.Tensor, tables) -> torch.Tensor:
    """Mean path lengths through the kernel the tables belong to."""
    if isinstance(tables, ext_path.PathRecords):
        return ext_sparse_mean(X, tables)
    return ext_dense_mean(X, tables)


def extended_path_lengths_dense(forest: ExtendedForest, X: torch.Tensor) -> torch.Tensor:
    """Mean path lengths of ``X`` through the dense EIF level walk,
    ``f32[N]``: the sparse kernel for ``k <= SPARSE_K_MAX``, the
    dense-table kernel above (``isoforest_tpu/ops/dense_traversal.py``'s
    ``extended_path_lengths_dense``, whose dots are HIGHEST-precision
    matmuls: another sum order, so the two agree to float32 rounding)."""
    return path_lengths_ext_dense(X, hyperplane_tables(forest))
