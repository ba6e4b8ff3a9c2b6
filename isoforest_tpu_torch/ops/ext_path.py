"""Compact per-node records and the path-walk core of ``csrc/path_walk.cu``,
shared by its three kernels: the standard walk ``walk_sum`` (:mod:`.walk`),
the EIF walk ``ext_walk_sum`` (:mod:`.ext_walk`) and the EIF
sparse-hyperplane level walk ``ext_sparse_mean`` (:mod:`.ext_dense`).

A record per internal node, in 16-byte chunks of int32 words: a header
``(threshold or offset bits, left code, right code, fourth word)``, then,
for an EIF node, its terms in chunks: three to a chunk ``(w0, w1, w2, i0 |
i1 << 10 | i2 << 20)`` where every feature index fits 10 bits (F <= 1024),
else two ``(w0, w1, i0, i1)``. An EIF header's fourth word is its term
count; a standard node's record is the header alone (``k = 0``), its fourth
word the split feature. Records of a tree are its internal heap slots in
ascending order (the top levels together), trees one after the other. A
child code ``< 0`` is ``~record`` of an internal node; ``>= 0`` is the
float32 bits of a leaf's path length (``depth + c(numInstances)``, +0.0 at a
hole), so a leaf costs the kernel no load. ``roots[t]`` is tree t's root
code.

The standard walk's bulk launch stages a forest's records in shared memory
a group of whole consecutive trees at a time, in tree order
(:func:`walk_groups`): each group within the records a block holds beside
its row tile on the card (``walk_staged_budget`` of the library), cut on
the host once a forest and width and passed to every launch.

A standard node sends the row right when ``x[feature] >= threshold``, an
EIF node when its hyperplane dot ``>= offset`` (NaN goes left). The EIF
kernels differ in the dot order (:func:`hyperplane_dot`) and the sum order
(a sum over trees, or ``acc += pl / T``). :func:`path_sum_plain` walks the
same records in plain PyTorch; :func:`launch` is the one place a kernel of
the core is launched, and counts it, in total and by the launch the kernel
took (:data:`VARIANTS`).
"""

from __future__ import annotations

import ctypes
from typing import Iterator, NamedTuple, Optional

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from ..telemetry.metrics import counter as _telemetry_counter
from ..utils.math import fma_f32
from . import _build

# The reference walk kernel's k fence (pallas_walk.py:84). The port's walk
# takes any k; the fence only switches the walk's dot order.
PAIRED_MAX_K = 16

# Batches of at most this many rows take the small-batch kernel (one warp a
# row, lanes over trees); larger ones one thread a row. Each is where the
# two launches cross on the H100 (tools/torch_port_kernel_paths.py, PERF.md):
# 65,536 rows for the EIF kernels, 98,304 for the standard walk.
TREE_PARALLEL_MAX_ROWS = {"walk_sum": 98_304, "ext_walk_sum": 1 << 16, "ext_sparse_mean": 1 << 16}

# Trees a round of the small-batch kernel: one a lane of a warp.
WARP_TREES = 32

KERNELS = ("walk_sum", "ext_walk_sum", "ext_sparse_mean")

# The launches a kernel of the core may take, by the code its entry reports
# (csrc/path_walk.cu, ``Variant``): the standard walk's records, a group of
# trees at a time, and its row tile in shared memory; the row tile there and
# the records through __ldg; rows too wide for the tile read through L1; one
# warp a row.
VARIANTS = ("staged", "tile", "global", "trees")

_P = ctypes.c_void_p
_I = ctypes.c_int
SIGNATURES = {**{name: (_P, _I, _I, _P, _I, _P, _I, _I, _I, _I, _P, _I, _P, _P, _P) for name in KERNELS},
              "path_variant": (_I, _I, _I, _I, _I, _I, _P, _I, _P),
              "walk_staged_budget": (_I, _P)}

# The widest row whose feature indices fit a record's 10-bit fields.
PACKED_MAX_FEATURES = 1 << 10


class PathRecords(NamedTuple):
    """``records`` int32 [R, 4 * (1 + ceil(k / chunk_terms))] and ``roots``
    int32 [T] (module docstring); ``k``, the most terms a record holds (0:
    a standard forest's header-only records); ``chunk_terms``, 3 (10-bit
    indices) or 2 (i32 indices); ``height``, the trees' heap height;
    ``min_features``, ``1 + max(index or feature)``: the narrowest row the
    kernel reads."""

    records: torch.Tensor
    roots: torch.Tensor
    k: int
    chunk_terms: int
    height: int
    min_features: int

    @property
    def num_trees(self) -> int:
        return self.roots.shape[0]


def pack_records(offset, left, right, terms, index, weight, chunk_terms: int) -> np.ndarray:
    """The record words of per-record numpy fields: ``offset`` f32,
    ``left``/``right``/``terms`` i32 ``[R]``, ``index`` i32 and ``weight``
    f32 ``[R, k]`` (0 past each record's terms), ``int32 [R, W]``."""
    r, k = index.shape
    chunks = -(-k // chunk_terms)
    body = np.zeros((r, chunks, 4), np.int32)
    w = np.zeros((r, chunks * chunk_terms), np.float32)
    w[:, :k] = weight
    ix = np.zeros((r, chunks * chunk_terms), np.int64)
    ix[:, :k] = index
    w, ix = w.reshape(r, chunks, chunk_terms), ix.reshape(r, chunks, chunk_terms)
    body[..., :chunk_terms] = w.view(np.int32)
    if chunk_terms == 3:
        body[..., 3] = ix[..., 0] | ix[..., 1] << 10 | ix[..., 2] << 20
    else:
        body[..., 2:] = ix
    head = np.stack([np.asarray(offset, np.float32).view(np.int32), left, right, terms], axis=1).astype(np.int32)
    return np.concatenate([head, body.reshape(r, 4 * chunks)], axis=1)


def build_path_records(internal, offset, leaf, index, weight, terms, height: int, device) -> PathRecords:
    """Records from heap-order numpy arrays: ``internal`` bool, ``offset``
    and ``leaf`` (the path length at a non-internal slot) f32 ``[T, M]``;
    ``index`` i32 and ``weight`` f32 ``[T, M, k]``, each node's terms first;
    ``terms`` i32 ``[T, M]``. With ``index`` and ``weight`` None, header-only
    records (``k = 0``) whose fourth word is ``terms``: a standard forest's
    split features. Built on the CPU, moved to ``device``."""
    t_n, m = np.shape(internal)
    k = 0 if index is None else index.shape[2]
    internal = np.array(internal, bool)
    internal[:, (m + 1) // 2 - 1 :] = False  # the bottom level holds only leaves
    leaf = np.where(internal, np.float32(0), np.asarray(leaf, np.float32))
    if not (leaf >= 0).all():
        raise ValueError("leaf path lengths must be >= 0")
    leaf = leaf + np.float32(0)  # -0.0 -> +0.0: adds the same to either sum
    rid = (np.cumsum(internal.ravel()) - 1).reshape(t_n, m)
    code = np.where(internal, ~rid, leaf.view(np.int32)).astype(np.int32)
    tt, ss = np.nonzero(internal)  # tree-major, slots ascending: record order
    terms = np.asarray(terms, np.int32)[tt, ss]
    if k == 0:
        used, weight = np.zeros((len(tt), 0), np.int32), np.zeros((len(tt), 0), np.float32)
        min_features = int(terms.max(initial=0)) + 1
    else:
        live = np.arange(k) < terms[:, None]
        used = np.where(live, np.asarray(index)[tt, ss], 0)
        weight = np.where(live, np.asarray(weight, np.float32)[tt, ss], np.float32(0))
        min_features = int(used.max(initial=0)) + 1
    chunk_terms = 3 if k == 0 or min_features <= PACKED_MAX_FEATURES else 2
    rec = pack_records(np.asarray(offset, np.float32)[tt, ss], code[tt, 2 * ss + 1], code[tt, 2 * ss + 2], terms,
                       used, weight, chunk_terms)
    return PathRecords(
        records=torch.from_numpy(rec).to(device),
        roots=torch.from_numpy(np.ascontiguousarray(code[:, 0])).to(device),
        k=k,
        chunk_terms=chunk_terms,
        height=height,
        min_features=min_features,
    )


def record_fields(p: PathRecords):
    """``(offset, left, right, terms, index, weight)`` of every record,
    decoded from the words the kernel reads."""
    rec = p.records
    r, chunks = rec.shape[0], rec.shape[1] // 4 - 1
    body = rec[:, 4:].reshape(r, chunks, 4)
    weight = body[..., : p.chunk_terms].reshape(r, chunks * p.chunk_terms)[:, : p.k].contiguous().view(torch.float32)
    if p.chunk_terms == 3:
        packed = body[..., 3:].long()
        index = torch.cat([packed & 0x3FF, packed >> 10 & 0x3FF, packed >> 20 & 0x3FF], dim=2)
    else:
        index = body[..., 2:].long()
    index = index.reshape(r, chunks * p.chunk_terms)[:, : p.k]
    return rec[:, 0].contiguous().view(torch.float32), rec[:, 1], rec[:, 2], rec[:, 3], index, weight


def hyperplane_dot(X: torch.Tensor, index: torch.Tensor, weight: torch.Tensor,
                   terms: Optional[torch.Tensor] = None, paired: Optional[bool] = None) -> torch.Tensor:
    """Each row's dot with its node's hyperplane, step by step as the
    kernel rounds it. ``index``/``weight``: ``[N, k]``, the terms of each
    row's node; ``terms``: ``[N]``, how many of them count (all k when
    None). ``paired`` (default: ``1 < k <= PAIRED_MAX_K``): ``x1*w1``, then
    ``fma(x0, w0, .)``, then the chain from q = 2, the walk kernel's order;
    else the chain ``fma(xq, wq, .)`` from 0."""
    k = index.shape[1]
    if paired is None:
        paired = 1 < k <= PAIRED_MAX_K
    xv = X.gather(1, index.long())
    if paired:
        dot = xv[:, 1] * weight[:, 1]
        dot = fma_f32(xv[:, 0], weight[:, 0], dot)
        first = 2
    else:
        dot = torch.zeros(X.shape[0], dtype=torch.float32, device=X.device)
        first = 0
    for q in range(first, k):
        step = fma_f32(xv[:, q], weight[:, q], dot)
        dot = step if terms is None else torch.where(q < terms, step, dot)
    return dot


def tree_path_lengths(X: torch.Tensor, p: PathRecords, paired: bool, tree_parallel: bool = False
                      ) -> Iterator[torch.Tensor]:
    """Each tree's path length of every row, ``f32[N]``, in tree order: the
    walk over the records in plain PyTorch, tree by tree as the bulk kernel's
    thread walks them, or (``tree_parallel``) ``WARP_TREES`` trees side by
    side as the small-batch kernel's lanes do. A standard node (``k = 0``)
    compares ``x[feature]``, an EIF node its dot in the ``paired`` order or
    the chain from 0."""
    offset, left, right, fourth, index, weight = record_fields(p)
    n = X.shape[0]
    group = WARP_TREES if tree_parallel else 1
    for t0 in range(0, p.num_trees, group):
        roots = p.roots[t0 : t0 + group].long()
        g = roots.shape[0]
        xg = X.repeat_interleave(g, dim=0) if g > 1 else X  # row i, tree t0 + j at i * g + j
        code = roots.repeat(n)
        for _ in range(p.height if p.records.shape[0] else 0):
            walking = code < 0
            node = torch.where(walking, ~code, 0)
            if p.k == 0:
                value = xg.gather(1, fourth[node].long()[:, None])[:, 0]
            else:
                value = hyperplane_dot(xg, index[node], weight[node], fourth[node], paired)
            code = torch.where(walking, torch.where(value >= offset[node], right[node], left[node]).long(), code)
        yield from code.to(torch.int32).view(torch.float32).view(n, g).unbind(1)


def path_sum_plain(X: torch.Tensor, p: PathRecords, paired: bool, mean: bool, tree_parallel: bool = False
                   ) -> torch.Tensor:
    """The core's function in plain PyTorch, ``f32[N]``: per tree in tree
    order ``acc += pl`` (``mean``: ``acc += pl / T``, a true division by a
    device tensor), each EIF dot in the ``paired`` order or the chain from
    0; ``tree_parallel`` walks as the small-batch kernel does, to the same
    sum."""
    acc = torch.zeros(X.shape[0], dtype=torch.float32, device=X.device)
    t_real = torch.tensor(float(p.num_trees), dtype=torch.float32, device=X.device)
    for pl in tree_path_lengths(X, p, paired, tree_parallel):
        acc = acc + (pl / t_real if mean else pl)
    return acc


def check_records(X: torch.Tensor, p: PathRecords, what: str) -> None:
    """Raise unless ``p`` suits ``X`` and the kernel."""
    if X.dtype != torch.float32 or X.dim() != 2 or not X.is_contiguous():
        raise ValueError(f"X must be a contiguous float32 [N, F] tensor, got {X.dtype} {tuple(X.shape)}")
    if X.shape[1] < 1:
        raise ValueError("X needs at least one feature column")
    if X.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on 'cuda' or 'cpu' tensors, got {X.device}")
    for name, a, dim in (("records", p.records, 2), ("roots", p.roots, 1)):
        if a.device != X.device or a.dtype != torch.int32 or a.dim() != dim or not a.is_contiguous():
            raise ValueError(f"{what} table {name!r} must be a contiguous int32 {dim}-D tensor on {X.device}, "
                             f"got {a.dtype} {tuple(a.shape)} on {a.device}")
    if (p.k == 0) != (what == "walk_sum"):
        raise ValueError(f"{what} takes {'header-only' if what == 'walk_sum' else 'hyperplane'} records, "
                         f"got records of k = {p.k} terms")
    if p.chunk_terms not in (2, 3) or p.records.shape[1] != 4 * (1 - (-p.k // p.chunk_terms)):
        raise ValueError(f"{what} table 'records' has {p.records.shape[1]} words a record, not k = {p.k}'s")
    if X.shape[1] < p.min_features:
        raise ValueError(f"X has {X.shape[1]} features, but the {what} tables read feature {p.min_features - 1}")
    if X.shape[0] >= 2**31 or p.records.shape[0] >= 2**31:
        raise ValueError(f"{what} takes fewer than 2^31 rows and records")


def tree_first_records(roots: np.ndarray, records: int) -> np.ndarray:
    """Each tree's first record, then ``records``, int64 ``[T + 1]``: tree t's
    records are ``[first[t], first[t + 1])`` (records are tree-major, a
    tree's root first; a single-leaf tree has none)."""
    roots = np.asarray(roots, np.int64)
    first = np.where(roots < 0, ~roots, records)
    first = np.minimum.accumulate(first[::-1])[::-1]  # a single-leaf tree starts where the next one does
    return np.append(first, records)


def walk_groups(first: np.ndarray, budget: int) -> Optional[np.ndarray]:
    """The staged walk's groups of whole consecutive trees, in tree order,
    each as many trees as fit ``budget`` records, int32 ``[2, G + 1]``: the
    first tree of each group, then T, and its first record, then the
    records' count; ``first`` as :func:`tree_first_records` gives it. None
    where a tree alone holds more than ``budget`` records (or ``budget`` <
    0): such a forest is not staged."""
    first = np.asarray(first, np.int64)
    if budget < 0 or (np.diff(first) > budget).any():
        return None
    trees = [0]
    while trees[-1] < len(first) - 1:
        trees.append(int(np.searchsorted(first, first[trees[-1]] + budget, side="right")) - 1)
    return np.ascontiguousarray(np.stack([trees, first[trees]]), dtype=np.int32)


# The staged walk's budget in records, by (device index, row width), and
# each forest's groups by budget, keyed by its roots: each computed once.
_BUDGETS: dict = {}
_GROUPS = WeakIdKeyDictionary()


def staged_groups(lib, p: PathRecords, f: int) -> Optional[np.ndarray]:
    """:func:`walk_groups` of standard records ``p`` within the budget that
    ``lib``'s ``walk_staged_budget`` gives rows of width ``f`` on the card
    the records are on, cached; None for an EIF (never staged) or where no
    group fits."""
    if p.k != 0:
        return None
    key = (p.records.device.index, f)
    budget = _BUDGETS.get(key)
    if budget is None:
        out = ctypes.c_int(-1)
        _build.check(lib.walk_staged_budget(f, ctypes.byref(out)), "walk_staged_budget")
        budget = _BUDGETS[key] = out.value
    by_budget = _GROUPS.setdefault(p.roots, {})
    if budget not in by_budget:
        by_budget[budget] = walk_groups(tree_first_records(p.roots.cpu().numpy(), p.records.shape[0]), budget)
    return by_budget[budget]


def _groups_args(groups: Optional[np.ndarray]):
    """A group table as the entries take it: its host pointer and count."""
    return (None, 0) if groups is None else (groups.ctypes.data, groups.shape[1] - 1)


# Launches of each kernel of csrc/path_walk.cu, counted where they happen:
# in all, and by the launch taken.
launches = {name: 0 for name in KERNELS}
variant_launches = {name: dict.fromkeys(VARIANTS, 0) for name in KERNELS}

_WALK_LAUNCHES_TOTAL = _telemetry_counter(
    "isoforest_walk_launches_total",
    "Launches of the path-walk kernels, by kernel and by the launch taken (staged, tile, global, trees)",
    labelnames=("kernel", "variant"),
)


def launch(name: str, X: torch.Tensor, p: PathRecords, tree_parallel: Optional[bool] = None) -> torch.Tensor:
    """Launch kernel ``name`` of ``csrc/path_walk.cu`` on CUDA ``X``, ``f32[N]``,
    and count it in ``launches[name]``, in ``variant_launches[name]`` under
    the launch it took and in ``isoforest_walk_launches_total{kernel,
    variant}`` (with telemetry on). ``tree_parallel``: the small-batch
    kernel (default: at most ``TREE_PARALLEL_MAX_ROWS[name]`` rows); the
    wrappers take the default, a caller that compares the two sides names
    one. A bulk launch of the standard walk passes the forest's groups
    (:func:`staged_groups`)."""
    n, f = X.shape
    out = torch.empty(n, dtype=torch.float32, device=X.device)
    if n == 0:
        return out
    if p.records.data_ptr() % 16:
        raise ValueError("the record table must be 16-byte aligned")
    if tree_parallel is None:
        tree_parallel = n <= TREE_PARALLEL_MAX_ROWS[name]
    lib = _build.load("path_walk", SIGNATURES)
    groups = None if tree_parallel else staged_groups(lib, p, f)
    taken = ctypes.c_int(-1)
    err = getattr(lib, name)(
        X.data_ptr(), n, f, p.records.data_ptr(), p.records.shape[0], p.roots.data_ptr(),
        p.num_trees, p.k, p.chunk_terms, int(tree_parallel), *_groups_args(groups), out.data_ptr(),
        torch.cuda.current_stream(X.device).cuda_stream, ctypes.byref(taken),
    )
    _build.check(err, name)
    variant = VARIANTS[taken.value]
    launches[name] += 1
    variant_launches[name][variant] += 1
    _WALK_LAUNCHES_TOTAL.inc(kernel=name, variant=variant)
    return out


def variant_and_groups(name: str, n: int, f: int, p: PathRecords):
    """The launch (one of :data:`VARIANTS`) that :func:`launch` of kernel
    ``name`` takes by default for ``n`` > 0 rows of width ``f`` over ``p`` on
    the current card, as the kernel's entry chooses it, and the groups it
    passes (None: none); launches nothing."""
    lib = _build.load("path_walk", SIGNATURES)
    small = n <= TREE_PARALLEL_MAX_ROWS[name]
    groups = None if small else staged_groups(lib, p, f)
    code = ctypes.c_int(-1)
    _build.check(lib.path_variant(n, f, p.records.shape[0], p.num_trees, p.k, int(small), *_groups_args(groups),
                                  ctypes.byref(code)), "path_variant")
    return VARIANTS[code.value], groups


def launch_variant(name: str, n: int, f: int, p: PathRecords) -> str:
    """The launch :func:`variant_and_groups` names."""
    return variant_and_groups(name, n, f, p)[0]


def span_attrs(name: str, p: PathRecords, rows: int, width: int, device: torch.device) -> dict:
    """What a scoring call through kernel ``name`` records on its span:
    ``walk_records_bytes``, the records' bytes; ``walk_variant``, the
    launch a chunk of ``rows`` rows of width ``width`` takes
    (:func:`launch_variant`; ``plain`` on the CPU, which runs the plain
    version); ``walk_groups``, the groups of trees that launch stages (0
    where it stages nothing); the last two none for no rows."""
    attrs = {"walk_records_bytes": p.records.numel() * p.records.element_size()}
    if rows > 0:
        variant, groups = variant_and_groups(name, rows, width, p) if device.type == "cuda" else ("plain", None)
        attrs["walk_variant"] = variant
        attrs["walk_groups"] = groups.shape[1] - 1 if variant == "staged" else 0
    return attrs
