"""The contamination threshold (``isoforest_tpu/ops/quantile.py``).

The reference sets the threshold as ``approxQuantile(scores, 1 -
contamination, contaminationError)``: an element of the score column whose
rank is within ``contaminationError * N`` of the target
(SharedTrainLogic.scala:187-197). An exact device sort answers whenever the
scores are few enough; above that, with a non-zero error budget, the
refined histogram of the JAX package answers, ported as it is (including
the FLT_MIN misranking ROADMAP §C records). The scores stay on their
device; only the histogram's counts and the answer come back.

XLA:CPU runs the JAX package's float32 steps with subnormals flushed: an
operand below FLT_MIN reads as a zero of its sign, and so does a result
(FTZ/DAZ), in arithmetic, comparisons and ``min``/``max`` alike; torch's
CPU and CUDA ops keep subnormals. The histogram's steps therefore flush
explicitly (:func:`_flush`), and a NaN bin goes where XLA's float-to-int
convert puts it, bin 0, by an explicit ``torch.where`` rather than by a
cast whose result differs between devices. The same bits come out on the
CPU and on the card.

:func:`histogram_quantile_sharded` is the JAX package's
``histogram_quantile_jit`` over row-sharded scores (the fused train step's
sketch, ``parallel/train_step.py``): the same passes in float32 device
arithmetic, each rank reading only its own rows; the global min and max are
two all-reduces, each pass's ``[num_bins + 2]`` counts one SUM all-reduce,
and the snap to an element one MIN all-reduce (:mod:`..parallel.mesh`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

_FLOAT32_TINY = torch.finfo(torch.float32).tiny


def exact_quantile(scores: torch.Tensor, q: float) -> float:
    """The element of ``scores`` at rank ``ceil(q * N) - 1`` (clamped), like
    an exact Greenwald-Khanna query: a sample element, no interpolation."""
    n = scores.shape[0]
    rank = min(max(int(math.ceil(q * n)) - 1, 0), n - 1)
    return float(torch.sort(scores).values[rank])


def _f32_resolution(lo: float, hi: float) -> float:
    """Width below which ``[lo, hi)`` cannot separate two float32 values."""
    scale = max(abs(lo), abs(hi), _FLOAT32_TINY)
    return float(scale * 2.0 ** (-24))


def _flush(t: torch.Tensor) -> torch.Tensor:
    """``t`` with each subnormal replaced by a zero of its sign, as XLA:CPU
    reads an operand and writes a result (NaN and the infinities stay)."""
    return torch.where(t.abs() < _FLOAT32_TINY, torch.copysign(torch.zeros_like(t), t), t)


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    """A host float as the float32 scalar tensor the reference's weakly
    typed Python float becomes, on ``like``'s device (a device tensor, so
    a division stays a division on the card), flushed as XLA reads it."""
    return _flush(torch.tensor(value, dtype=torch.float32, device=like.device))


def histogram_quantile(
    scores: torch.Tensor,
    q: float,
    num_bins: int = 1 << 14,
    lo: float | None = None,
    hi: float | None = None,
    eps: float = 1e-3,
    max_passes: int = 24,
) -> float:
    """Iteratively refined histogram quantile returning an element of
    ``scores`` whose rank is within ``eps * N`` of ``ceil(q * N)``.

    Each pass histograms the scores over ``[lo, hi]`` (default: their
    min/max), narrows to the target bin widened by one bin on each side,
    and stops once that window holds at most ``eps * N`` scores or falls
    below float32 resolution; the answer is the smallest score at or above
    the final lower edge. The arithmetic is the JAX package's: float32 on
    the device, the edges in Python floats.
    """
    scores = torch.as_tensor(scores).to(torch.float32)
    # the scores as every float32 step of the reference reads them
    flushed = _flush(scores)
    n = scores.shape[0]
    if lo is None:
        lo = float(flushed.min())
    if hi is None:
        hi = float(flushed.max())
    target = max(int(math.ceil(q * n)), 1)
    rank_budget = max(int(eps * n), 1)
    for _ in range(max_passes):
        width = hi - lo
        if width <= 0:
            break
        rel = _flush(flushed - _f32(lo, scores))
        rel = _flush(rel / _f32(width, scores))
        rel = torch.floor(_flush(rel * num_bins))
        # XLA's convert puts a NaN at 0; the clip leaves no infinity
        bins = torch.where(rel.isnan(), 0.0, rel.clamp(-1, num_bins)).to(torch.int64)
        # the last bin is right-closed, including scores that round up to it
        bins = torch.where(flushed <= _f32(hi, scores), bins.clamp(max=num_bins - 1), bins)
        # slot 0 counts scores below lo
        all_counts = torch.bincount(bins + 1, minlength=num_bins + 2).cpu().numpy()
        counts = all_counts[1 : num_bins + 1]
        cum = all_counts[0] + np.cumsum(counts)
        idx = min(int(np.searchsorted(cum, target)), num_bins - 1)
        # one-bin widening around the target bin; the outer edges stay exact
        lo_i = max(idx - 1, 0)
        hi_i = min(idx + 1, num_bins - 1)
        new_lo = lo if lo_i == 0 else lo + lo_i * width / num_bins
        new_hi = hi if hi_i == num_bins - 1 else lo + (hi_i + 1) * width / num_bins
        window = int(cum[hi_i] - (cum[lo_i - 1] if lo_i > 0 else all_counts[0]))
        lo, hi = new_lo, new_hi
        if window <= rank_budget or (hi - lo) <= _f32_resolution(lo, hi):
            break
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=scores.device)
    return float(torch.where(flushed >= _f32(lo, scores), flushed, inf).min())


def histogram_quantile_sharded(mesh, scores: torch.Tensor, num_rows: int, q: float, num_bins: int = 8192,
                               eps: float = 1e-3, max_passes: int = 24) -> float:
    """The refined histogram quantile of ``histogram_quantile_jit`` over a
    score column sharded across the ranks of ``mesh``: ``scores`` holds this
    rank's rows (all of them in one process), ``num_rows`` is the column's
    length. Returns an element of the column whose rank is within ``eps *
    num_rows`` of ``ceil(q * num_rows)``: every pass histograms the
    ``[lo, hi]`` window, narrows to the target bin widened by one bin on
    each side (the outer edges stay exact), and the loop ends after
    ``max_passes``, once the window holds at most ``eps * num_rows`` scores,
    or below float32 resolution; then the smallest score ``>= lo``."""
    from ..parallel.mesh import reduce_shards

    scores = scores.to(torch.float32)
    n = int(num_rows)
    target = max(int(math.ceil(np.float32(q * n))), 1)
    rank_budget = max(int(eps * n), 1)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=scores.device)
    lo = reduce_shards(mesh, [scores.min() if scores.numel() else inf], "min")
    hi = reduce_shards(mesh, [scores.max() if scores.numel() else -inf], "max")
    lo, hi = np.float32(lo.item()), np.float32(hi.item())
    tiny = np.float32(_FLOAT32_TINY)
    bin_count, passes = n, 0
    while passes < max_passes and bin_count > rank_budget and \
            (hi - lo) > max(abs(lo), abs(hi), tiny) * np.float32(2.0 ** -24):
        width = max(np.float32(hi - lo), tiny)
        # device scalars: a division stays a division on the card
        rel = torch.floor((scores - _f32(float(lo), scores)) / _f32(float(width), scores) * num_bins)
        bins = torch.where(rel.isnan(), 0.0, rel.clamp(-1, num_bins)).to(torch.int64)
        # the last bin is right-closed, including scores that round up to it
        bins = torch.where(scores <= _f32(float(hi), scores), bins.clamp(max=num_bins - 1), bins)
        counts = torch.bincount(bins + 1, minlength=num_bins + 2)
        counts = reduce_shards(mesh, [counts], "sum").cpu().numpy()
        cum = counts[0] + np.cumsum(counts[1 : num_bins + 1])
        idx = min(max(int(np.searchsorted(cum, target)), 0), num_bins - 1)
        lo_i, hi_i = max(idx - 1, 0), min(idx + 1, num_bins - 1)
        new_lo = lo if lo_i == 0 else np.float32(lo + np.float32(lo_i) * width / np.float32(num_bins))
        new_hi = hi if hi_i == num_bins - 1 else np.float32(lo + np.float32(hi_i + 1) * width / np.float32(num_bins))
        bin_count = int(cum[hi_i] - (cum[lo_i - 1] if lo_i > 0 else counts[0]))
        lo, hi, passes = new_lo, new_hi, passes + 1
    snap = torch.where(scores >= _f32(float(lo), scores), scores, inf).min() if scores.numel() else inf
    return float(reduce_shards(mesh, [snap], "min"))


def contamination_threshold(
    scores: torch.Tensor,
    contamination: float,
    contamination_error: float,
    exact_size_limit: int = 1 << 22,
) -> float:
    """Outlier-score threshold for a contamination level: exact when the
    error budget is 0 or the scores number at most ``exact_size_limit``,
    else the refined histogram within the budget."""
    q = 1.0 - contamination
    if contamination_error == 0.0 or scores.numel() <= exact_size_limit:
        return exact_quantile(scores, q)
    return histogram_quantile(scores, q, eps=contamination_error)


def quantile_rank_error(scores: torch.Tensor, threshold: float, q: float) -> int:
    """Distance from the target rank ``ceil(q * N)`` to the rank interval
    ``[count(< thr) + 1, count(<= thr)]`` the threshold occupies (0 when it
    covers the target). Raises ValueError if the threshold is not an
    element of ``scores``."""
    n = scores.numel()
    target = max(int(math.ceil(q * n)), 1)
    thr = torch.tensor(threshold, dtype=scores.dtype, device=scores.device)
    lt = int((scores < thr).sum())
    le = int((scores <= thr).sum())
    if le == lt:
        raise ValueError(f"threshold {threshold!r} is not an element of the score column")
    if target < lt + 1:
        return (lt + 1) - target
    if target > le:
        return target - le
    return 0


def observed_contamination(scores: torch.Tensor, threshold: float) -> float:
    """Fraction of rows labelled outliers by ``threshold``, for the
    reference's verification warning (SharedTrainLogic.scala:211-232)."""
    thr = torch.tensor(threshold, dtype=scores.dtype, device=scores.device)
    return float((scores >= thr).to(torch.float32).mean())
