"""Level-window scaffolding of level-synchronous growth
(``isoforest_tpu/ops/level_window.py``), batched over trees.

Per-level state lives in a ``W = 2^h`` window of rows instead of the full
``M``-slot heap, and per-level statistics and draws stream over features in
chunks of ``FEATURE_CHUNK``. The chunk width is part of the random stream
(each chunk's Gumbel draws come from ``fold_in(k_feat, chunk)``), so it is
the JAX package's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

FEATURE_CHUNK = 64


class ChunkGeometry(NamedTuple):
    x: torch.Tensor  # [..., F + pad]: zero-padded, so padded columns are constant
    chunk: int  # chunk width Fc
    pad: int  # zero columns appended
    n_chunks: int


def chunk_features(x: torch.Tensor, feature_chunk: int = FEATURE_CHUNK) -> ChunkGeometry:
    """Pad the last axis of ``x`` to a multiple of the chunk width
    ``min(F, feature_chunk)``."""
    f = x.shape[-1]
    fc = min(f, feature_chunk)
    pad = (-f) % fc
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    return ChunkGeometry(x=x, chunk=fc, pad=pad, n_chunks=(f + pad) // fc)


class LevelWindow(NamedTuple):
    start: int  # first heap slot of level l
    width: int  # real nodes at level l (2^l)
    in_level: torch.Tensor  # bool [W]: the window row is a real level-l node
    idx_of_sample: torch.Tensor  # int64 [T, S]: window row per sample; W = settled


def level_window(l: int, w: int, node_id: torch.Tensor, settled: torch.Tensor) -> LevelWindow:
    """Window view of level ``l`` of a ``W``-row state. Unsettled samples
    sit exactly at level ``l``, so their row is ``node_id - start``; settled
    samples map to the sentinel row ``W``, which statistics drop."""
    start, width = (1 << l) - 1, 1 << l
    j = torch.arange(w, device=node_id.device)
    return LevelWindow(
        start=start,
        width=width,
        in_level=j < width,
        idx_of_sample=torch.where(settled, w, node_id - start),
    )


def patch(arr: torch.Tensor, new_w: torch.Tensor, mask: torch.Tensor, start: int) -> torch.Tensor:
    """Write the window ``new_w [T, W]`` into the heap table ``arr [T, M]``
    at slot ``start`` where ``mask`` holds, in place; returns ``arr``."""
    w = new_w.shape[1]
    view = arr[:, start : start + w]
    view.copy_(torch.where(mask, new_w.to(arr.dtype), view))
    return arr


def spawn_children(exists: torch.Tensor, can_split: torch.Tensor, win: LevelWindow) -> torch.Tensor:
    """Mark the children of splitting window rows as existing slots, in
    place. The children ``2s+1, 2s+2`` of level l's rows are the first
    ``2 * width`` slots of level l + 1, in order."""
    if 2 * win.width + 2 * win.start + 1 > exists.shape[1]:  # the last level: no children
        return exists
    child_start = 2 * win.start + 1
    split = can_split[:, : win.width].repeat_interleave(2, dim=1)
    exists[:, child_start : child_start + 2 * win.width] |= split
    return exists
