"""Gather-free dense level walk: the port of ``isoforest_tpu/ops/pallas_traversal.py``
(standard kernel) and the standard half of ``ops/dense_traversal.py``.

The CUDA kernel's wrapper (``csrc/dense.cu``), its plain PyTorch version
(:func:`dense_mean_plain`: every internal-capable slot's go-right bit, then
each row's path along its bits) and a launch counter. Both accumulate
``pl / T`` tree by tree, in tree order, as ``_standard_kernel``'s source
does (``pallas_traversal.py:190``), and agree with each other bit for bit.
They agree with that kernel in interpret mode bit for bit where ``T`` is a
power of two and the port's ``c(n)`` equals the JAX package's: XLA on the
CPU turns the kernel's ``pl / T`` into a multiply-add with the rounded
``1 / T``, which is exact only then.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.math import height_of
from . import _build
from .scoring_layout import StandardLayout, pack_standard
from .tree_growth import StandardForest

# Height fence of csrc/dense.cu (kMaxHeight, derived there from registers),
# and of both EIF dense kernels. The walk strategy has no fence.
DENSE_MAX_HEIGHT = 10

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"dense_mean": (_P, _I, _I, _P, _P, _I, _I, _P, _P)}


def dense_mean_plain(X: torch.Tensor, tables: StandardLayout) -> torch.Tensor:
    """The kernel's function, in its steps, in plain PyTorch: per tree the
    go-right bits ``x[feature] >= value`` of the ``2^h - 1``
    internal-capable slots, each row's path from the root along them, and
    the exit slot's merged value as the tree's path length; ``sum_t pl_t /
    T`` in tree order."""
    n = X.shape[0]
    t_count, m = tables.value.shape
    h = height_of(m)
    m_int = (m + 1) // 2 - 1
    t_real = torch.tensor(float(t_count), dtype=torch.float32, device=X.device)
    acc = torch.zeros(n, dtype=torch.float32, device=X.device)
    for t in range(t_count):
        feature, value = tables.feature[t], tables.value[t]
        node = torch.zeros(n, dtype=torch.long, device=X.device)
        if m_int:
            right = X[:, feature[:m_int].clamp(min=0).long()] >= value[:m_int]
            for _ in range(h):
                b = right.gather(1, node.clamp(max=m_int - 1)[:, None])[:, 0]
                node = torch.where(feature[node] >= 0, 2 * node + 1 + b.long(), node)
        acc = acc + value[node] / t_real
    return acc


def dense_mean(X: torch.Tensor, tables: StandardLayout) -> torch.Tensor:
    """Mean path length over trees, ``f32[N]``, accumulated as ``pl / T``.

    On a CUDA tensor this launches ``csrc/dense.cu`` and counts the launch in
    ``dense_mean.launches``; on a CPU tensor it runs :func:`dense_mean_plain`.
    """
    _check_inputs(X, tables)
    if X.device.type == "cpu":
        return dense_mean_plain(X, tables)
    if X.device.type != "cuda":
        raise ValueError(f"dense_mean runs on 'cuda' or 'cpu' tensors, got {X.device}")
    n, f = X.shape
    out = torch.empty(n, dtype=torch.float32, device=X.device)
    if n == 0:
        return out
    lib = _build.load("dense", _SIGNATURES)
    t_count, m = tables.value.shape
    err = lib.dense_mean(
        X.data_ptr(), n, f, tables.feature.data_ptr(), tables.value.data_ptr(),
        t_count, height_of(m), out.data_ptr(),
        torch.cuda.current_stream(X.device).cuda_stream,
    )
    _build.check(err, "dense_mean")
    dense_mean.launches += 1
    return out


dense_mean.launches = 0


def _check_inputs(X: torch.Tensor, tables: StandardLayout) -> None:
    if X.dtype != torch.float32 or X.dim() != 2 or not X.is_contiguous():
        raise ValueError(f"X must be a contiguous float32 [N, F] tensor, got {X.dtype} {tuple(X.shape)}")
    if X.shape[1] < 1:
        raise ValueError("X needs at least one feature column")
    shape = tables.value.shape
    for name, a, dtype in (("value", tables.value, torch.float32), ("feature", tables.feature, torch.int32)):
        if a.device != X.device or a.dtype != dtype or a.shape != shape or not a.is_contiguous():
            raise ValueError(
                f"dense table {name!r} must be a contiguous {dtype} {tuple(shape)} tensor "
                f"on {X.device}, got {a.dtype} {tuple(a.shape)} on {a.device}"
            )
    h = height_of(shape[1])
    if h > DENSE_MAX_HEIGHT:
        raise ValueError(
            f"the dense kernel supports trees of height <= DENSE_MAX_HEIGHT="
            f"{DENSE_MAX_HEIGHT} (a lane's go-right words live in registers); this forest "
            f"has height {h}: use strategy='walk'"
        )
    if X.shape[0] >= 2**31:
        raise ValueError("the dense kernel takes fewer than 2^31 rows")


def standard_path_lengths_dense(forest: StandardForest, X: torch.Tensor) -> torch.Tensor:
    """Mean path lengths of ``X`` through the dense level walk, ``f32[N]``."""
    return dense_mean(X, pack_standard(forest))
