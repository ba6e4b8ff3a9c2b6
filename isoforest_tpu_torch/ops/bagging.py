"""Per-tree bags and feature subsets (``isoforest_tpu/ops/bagging.py``).

Every tree receives ``numSamples`` rows drawn uniformly, with replacement
iff ``bootstrap``, and a sorted random subset of ``numFeatures`` features
(BaggedPoint.scala:114-217, SharedTrainLogic.scala:99-153, 300-304). The
draws are the JAX package's, bit for bit: the same threefry keys
(:mod:`.prng`), the same dispatch between samplers, and the same samplers.
Everything is drawn on the device of the key, for all trees in one call.

The streamed samplers of an out-of-core fit (:class:`StreamedBagger`,
:func:`streamed_bootstrap_indices`) are host numpy over ``uint64``, copied
from the JAX package so their samples match it bit for bit: the rows come
from the host stream, the sample is at most ``T * S`` rows, and torch's
unsigned types lack the shifts and gathers these hashes need on the card.
"""

from __future__ import annotations

import hashlib
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import prng

# Dispatch thresholds (bagging.py:32, :36): the full per-tree permutation
# is used while T * N stays below this many elements...
PERMUTATION_MAX_ELEMS = 1 << 26
# ...and Floyd's O(S^2) sampler up to this bag size; the top-k sampler above.
FLOYD_MAX_SAMPLES = 1 << 12


def per_tree_keys(key: torch.Tensor, num_trees: int) -> torch.Tensor:
    """``fold_in(key, tree_id)`` for every tree: ``[num_trees, 2]``."""
    return prng.fold_in(key, torch.arange(num_trees, device=key.device))


def _floyd_sample(tree_keys: torch.Tensor, num_rows: int, num_samples: int) -> torch.Tensor:
    """Floyd's exact uniform ``num_samples``-subset of ``[0, num_rows)`` per
    tree: for ``j = N-S .. N-1`` draw ``t ~ U[0, j]``, keep ``t`` unless
    already drawn, else keep ``j``. The draws ``randint(fold_in(key, i), 0,
    j + 1)`` do not depend on the buffer, so all are drawn in one call; only
    the O(S) dedup runs step by step."""
    dev = tree_keys.device
    i = torch.arange(num_samples, device=dev)
    j = num_rows - num_samples + i
    draws = prng.randint(prng.fold_in(tree_keys[:, None, :], i), (), 0, j + 1)  # [T, S]
    buf = torch.full_like(draws, -1)
    for step in range(num_samples):
        t = draws[:, step]
        seen = (buf[:, :step] == t[:, None]).any(dim=1)
        buf[:, step] = torch.where(seen, j[step].to(torch.int32), t)
    return buf


def _topk_sample(tree_keys: torch.Tensor, num_rows: int, num_samples: int) -> torch.Tensor:
    """Exact uniform subsets for large bags: rank each tree's rows by a
    64-bit random key (two words, compared lexicographically by a stable
    sort) and keep the ``num_samples`` highest. Trees go in chunks so the
    ``[chunk, N]`` transient stays bounded; chunking does not change a draw."""
    num_trees = tree_keys.shape[0]
    chunk = max(1, min(num_trees, PERMUTATION_MAX_ELEMS // max(num_rows, 1)))
    parts = []
    for t0 in range(0, num_trees, chunk):
        k = prng.split(tree_keys[t0 : t0 + chunk])
        r1 = prng.bits(k[:, 0, :], (num_rows,))
        r2 = prng.bits(k[:, 1, :], (num_rows,))
        # (r1, r2) as one signed 64-bit key with the same order
        key64 = ((r1 - (1 << 31)) << 32) + r2
        order = torch.sort(key64, dim=1, stable=True).indices
        parts.append(order[:, num_rows - num_samples :].to(torch.int32))
    return torch.cat(parts)


def _bagged_indices(key, num_rows, num_samples, num_trees, bootstrap, perm_max, floyd_max):
    """The sampler dispatch of ``_bagged_indices_jit`` (bagging.py:111-134);
    the thresholds come in as arguments so tests can reach every branch."""
    tree_keys = per_tree_keys(key, num_trees)
    if bootstrap:
        return prng.randint(tree_keys, (num_samples,), 0, num_rows)
    if num_samples <= floyd_max and num_samples * num_samples <= 200 * num_rows:
        return _floyd_sample(tree_keys, num_rows, num_samples)
    if num_rows * num_trees <= perm_max:
        return prng.permutation(tree_keys, num_rows)[:, :num_samples].to(torch.int32)
    if num_samples <= floyd_max:
        return _floyd_sample(tree_keys, num_rows, num_samples)
    return _topk_sample(tree_keys, num_rows, num_samples)


def bagged_indices(
    key: torch.Tensor,
    num_rows: int,
    num_samples: int,
    num_trees: int,
    bootstrap: bool,
) -> torch.Tensor:
    """``int32 [num_trees, num_samples]`` row indices, one bag per tree, on
    the key's device. Without ``bootstrap`` the rows of a bag are distinct,
    so a bag larger than the data is refused."""
    if not bootstrap and num_samples > num_rows:
        raise ValueError(
            f"cannot draw {num_samples} distinct rows from {num_rows} without "
            "replacement (bootstrap=False)"
        )
    return _bagged_indices(
        key, num_rows, num_samples, num_trees, bootstrap, PERMUTATION_MAX_ELEMS, FLOYD_MAX_SAMPLES
    )


def feature_subsets(
    key: torch.Tensor, total_num_features: int, num_features: int, num_trees: int
) -> torch.Tensor:
    """Per-tree sorted random feature subsets, ``int32 [num_trees,
    num_features]``: ``shuffle(0..F-1).take(numFeatures).sorted``
    (SharedTrainLogic.scala:300-304)."""
    perm = prng.permutation(per_tree_keys(key, num_trees), total_num_features)
    return torch.sort(perm[:, :num_features], dim=1).values.to(torch.int32)


def ensemble_draws(
    key: torch.Tensor,
    X: torch.Tensor,
    *,
    num_samples: int,
    num_trees: int,
    bootstrap: bool,
    num_features: int,
    bag: Optional[torch.Tensor] = None,
):
    """Every draw of a fit's ensemble from its key, in the JAX package's
    order: ``(k_bag, k_feat, k_grow) = split(key, 3)``, then the bags
    (``bag``, when given, replaces them: a fit from a sample), the feature
    subsets and the per-tree keys, as ``(tree_keys, bag, feat_idx)``.

    A checkpointed fit slices these per block rather than drawing per
    block, since the samplers' dispatch depends on the tree count; so the
    plain fit and the checkpointed one grow the same trees.
    """
    num_rows, num_features_total = int(X.shape[0]), int(X.shape[1])
    k_bag, k_feat, k_grow = prng.split(key, 3)
    if bag is None:
        bag = bagged_indices(k_bag, num_rows, num_samples, num_trees, bootstrap)
    feat_idx = feature_subsets(k_feat, num_features_total, num_features, num_trees)
    return per_tree_keys(k_grow, num_trees), bag, feat_idx


def gather_tree_data(X: torch.Tensor, bag_idx: torch.Tensor, feat_idx: torch.Tensor) -> torch.Tensor:
    """Per-tree training slabs ``f32 [T, S, num_features]``: the bag's rows,
    the tree's features."""
    rows = X[bag_idx.long()]  # [T, S, F]
    return rows.gather(2, feat_idx.long()[:, None, :].expand(-1, rows.shape[1], -1))


# The streamed samplers (bagging.py:209-443). Every (tree, absolute row)
# pair gets a splitmix64 key from the seed; a tree keeps the S rows of
# smallest key, a symmetric function of i.i.d. draws, so every S-subset is
# equally likely. Keys depend on the seed and the absolute row alone, so a
# sample is the same for any chunking and any re-read of the source.

_GOLDEN = np.uint64(0x9E3779B97F4A7C15)
_MIX_1 = np.uint64(0xBF58476D1CE4E5B9)
_MIX_2 = np.uint64(0x94D049BB133111EB)
_KEY_SENTINEL = np.uint64(0xFFFFFFFFFFFFFFFF)
_ROW_SENTINEL = np.int64(2**63 - 1)
# Rows hashed per inner block: the [T, block] keys stay tens of MB.
_STREAM_BLOCK_ROWS = 1 << 16


def _mix64(x: np.ndarray) -> np.ndarray:
    """The splitmix64 finalizer over uint64 arrays (Steele et al. 2014)."""
    x = np.asarray(x, dtype=np.uint64).copy()
    x ^= x >> np.uint64(30)
    x *= _MIX_1
    x ^= x >> np.uint64(27)
    x *= _MIX_2
    x ^= x >> np.uint64(31)
    return x


def _tree_salts(seed: int, num_trees: int) -> np.ndarray:
    """Per-tree uint64 salts: the splitmix64 stream of ``seed``, finalized."""
    base = np.uint64(seed & 0xFFFFFFFFFFFFFFFF)
    t = np.arange(1, num_trees + 1, dtype=np.uint64)
    return _mix64(base + t * _GOLDEN)


def _row_hash(global_rows: np.ndarray) -> np.ndarray:
    """``uint64[C]`` mixed values of absolute row indices, one splitmix a
    row, shared by every tree."""
    return _mix64((global_rows.astype(np.uint64) + np.uint64(1)) * _GOLDEN)


def _row_keys(xor_salts: np.ndarray, mul_salts: np.ndarray, row_hash: np.ndarray) -> np.ndarray:
    """``uint64[T, C]`` keys of (tree, absolute row): a tree's salt xored
    in, its odd multiplier, an xor-shift and a fixed odd multiplier, a
    bijection of uint64 per tree over the row's i.i.d. key."""
    keys = np.bitwise_xor(xor_salts[:, None], row_hash[None, :])
    keys *= mul_salts[:, None]
    keys ^= keys >> np.uint64(29)
    keys *= _MIX_2
    return keys


class StreamedSample(NamedTuple):
    """A streamed sampler's sample: ``X`` the union of selected rows
    (``f32[U, F]``, ascending source row), ``bag`` each tree's indices into
    it (``int32[T, S]``), ``rows`` their absolute source rows (``int64[U]``),
    ``total_rows`` the stream's length, ``sha256`` the content's hash (a
    checkpoint's ``samplerSha256``)."""

    X: np.ndarray
    bag: np.ndarray
    rows: np.ndarray
    total_rows: int
    sha256: str


def _sample_sha256(X: np.ndarray, bag: np.ndarray, rows: np.ndarray) -> str:
    h = hashlib.sha256()
    h.update(repr((X.shape, str(X.dtype), bag.shape)).encode())
    h.update(np.ascontiguousarray(X).tobytes())
    h.update(np.ascontiguousarray(bag).tobytes())
    h.update(np.ascontiguousarray(rows).tobytes())
    return h.hexdigest()


class StreamedBagger:
    """One-pass bottom-S reservoir over a row stream of any length, without
    replacement per tree: :meth:`consume` sequential chunks (absolute row
    order, no gaps), then :meth:`finalize`. It holds the reservoirs (``[T,
    S]`` keys and rows) and the rows they select (at most ``T * S``),
    whatever the stream's length."""

    def __init__(self, seed: int, num_trees: int, num_samples: int):
        if num_trees <= 0 or num_samples <= 0:
            raise ValueError(f"need num_trees > 0 and num_samples > 0, got {num_trees}/{num_samples}")
        self.num_trees = int(num_trees)
        self.num_samples = int(num_samples)
        self._xor_salts = _tree_salts(seed, num_trees)
        # odd multipliers, so each is a bijection mod 2^64
        self._mul_salts = _tree_salts(~seed & 0xFFFFFFFFFFFFFFFF, num_trees) | np.uint64(1)
        # each tree's reservoir sorted by (key, row); column -1 is its admission bar
        self._res_keys = np.full((num_trees, num_samples), _KEY_SENTINEL, dtype=np.uint64)
        self._res_rows = np.full((num_trees, num_samples), _ROW_SENTINEL, dtype=np.int64)
        self._store: dict = {}  # global row -> f32 feature row
        self._rows_seen = 0
        self._num_features: Optional[int] = None

    def consume(self, X_chunk: np.ndarray) -> None:
        X = np.asarray(X_chunk, dtype=np.float32)
        if X.ndim != 2:
            raise ValueError(f"chunk must be 2-D, got shape {X.shape}")
        if self._num_features is None:
            self._num_features = X.shape[1]
        elif X.shape[1] != self._num_features:
            raise ValueError(f"chunk width {X.shape[1]} != source width {self._num_features}")
        start = self._rows_seen
        for off in range(0, X.shape[0], _STREAM_BLOCK_ROWS):
            self._consume_block(X[off : off + _STREAM_BLOCK_ROWS], start + off)
        self._rows_seen += X.shape[0]

    def _consume_block(self, X: np.ndarray, start: int) -> None:
        rows = np.arange(start, start + X.shape[0], dtype=np.int64)
        keys = _row_keys(self._xor_salts, self._mul_salts, _row_hash(rows))  # [T, C]
        # a row enters iff its key beats the tree's current bar; a tie loses
        # to the incumbent, whose row is always earlier
        cand = keys < self._res_keys[:, -1][:, None]
        touched = np.nonzero(cand.any(axis=1))[0]
        for t in touched:
            ck, cr = keys[t, cand[t]], rows[cand[t]]
            mk = np.concatenate([self._res_keys[t], ck])
            mr = np.concatenate([self._res_rows[t], cr])
            order = np.lexsort((mr, mk))[: self.num_samples]
            self._res_keys[t] = mk[order]
            self._res_rows[t] = mr[order]
        if len(touched) == 0:
            return
        # keep this block's survivors' rows, drop the evicted ones
        live = np.unique(self._res_rows)
        live = live[live != _ROW_SENTINEL]
        fresh = live[(live >= start) & (live < start + X.shape[0])]
        for r in fresh.tolist():
            self._store[r] = X[r - start].copy()
        if len(self._store) > live.size:
            live_set = set(live.tolist())
            for r in [r for r in self._store if r not in live_set]:
                del self._store[r]

    def finalize(self) -> StreamedSample:
        """The sample; raises if the stream had fewer than ``num_samples`` rows."""
        if self._rows_seen < self.num_samples:
            raise ValueError(
                f"cannot draw {self.num_samples} distinct rows from a "
                f"{self._rows_seen}-row stream (bootstrap=False)"
            )
        rows = np.unique(self._res_rows)
        rows = rows[rows != _ROW_SENTINEL]
        X = np.stack([self._store[r] for r in rows.tolist()]).astype(np.float32)
        bag = np.searchsorted(rows, self._res_rows).astype(np.int32)
        return StreamedSample(X=X, bag=bag, rows=rows, total_rows=self._rows_seen,
                              sha256=_sample_sha256(X, bag, rows))


def streamed_bootstrap_indices(seed: int, num_trees: int, num_samples: int, total_rows: int) -> np.ndarray:
    """With-replacement bags of a streamed fit: ``int64[T, S]`` absolute
    rows, each slot ``key(t, s) mod N`` from the reservoir's splitmix64
    stream. Needs ``total_rows`` first, so a bootstrap fit counts the
    source's rows before its data pass."""
    if total_rows <= 0:
        raise ValueError(f"dataset is empty (totalRows={total_rows})")
    salts = _tree_salts(~seed & 0xFFFFFFFFFFFFFFFF, num_trees)
    slots = np.arange(1, num_samples + 1, dtype=np.uint64) * _GOLDEN
    keys = _mix64(salts[:, None] ^ _mix64(slots)[None, :])
    return (keys % np.uint64(total_rows)).astype(np.int64)


def materialise_bootstrap_sample(chunks, indices: np.ndarray) -> StreamedSample:
    """The rows :func:`streamed_bootstrap_indices` named, gathered in one
    pass over ``chunks`` (objects with ``.X`` and ``.global_start``), as a
    :class:`StreamedSample`: ``X`` the distinct rows, ``bag`` each slot's
    position among them."""
    rows = np.unique(indices)
    X_parts: dict = {}
    total = 0
    for chunk in chunks:
        start = chunk.global_start
        stop = start + chunk.X.shape[0]
        total = stop
        lo, hi = np.searchsorted(rows, [start, stop])
        for r in rows[lo:hi].tolist():
            X_parts[r] = np.asarray(chunk.X[r - start], dtype=np.float32).copy()
    missing = [r for r in rows.tolist() if r not in X_parts]
    if missing:
        raise ValueError(
            f"bootstrap drew row {missing[0]} but the stream ended at "
            f"{total} rows (source shrank between the counting and data passes?)"
        )
    X = np.stack([X_parts[r] for r in rows.tolist()]).astype(np.float32)
    bag = np.searchsorted(rows, indices).astype(np.int32)
    return StreamedSample(X=X, bag=bag, rows=rows, total_rows=total, sha256=_sample_sha256(X, bag, rows))
