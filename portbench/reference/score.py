"""The plain scorer: every row's path through every tree of the benchmark's
forest arrays, in plain torch operations, in blocks of rows.

A standard node sends a row right when ``x[feature] >= threshold``; an
extended node when ``dot(x, w) >= offset``, the dot taken in float64 over
all of a tree's internal slots at once as one product. A row that ends at
a leaf of depth ``d`` holding ``n`` training rows credits ``d + c(n)``, with
``c(n) = 2 (ln(n - 1) + gamma) - 2 (n - 1) / n`` (0 for ``n <= 1``); the
score is ``2^(-mean / c(max_samples))``. Sums and scores are float64.

Besides the scores it gives each row's ``tolerance`` and counts the work
the scoring needs on these very rows (``visited``: the internal nodes each
row's path visits, which the roofline turns into operations, :func:`work`).

The tolerance is how far a correct float32 program may score a row from
the float64 reference: ``ROW_TOLERANCE`` for its sums of path lengths, and,
for every tree whose path on that row passes an extended node whose dot
lies within the float32 error bound of its offset (``gamma_k * sum |w x|``,
``gamma_k = k u / (1 - k u)``), that tree's whole range of leaf values: a
correct float32 dot may take either branch there. A standard node compares
float32 values exactly and is never near a tie.

``precision`` selects the control of ``correct``'s comparison: ``"bf16"``
compares standard rows and thresholds rounded to bfloat16, ``"tf32"`` takes
the extended dots over inputs rounded to TF32's 10-bit mantissa with float32
sums. Neither is the truth; they are what a lower precision would answer.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

EULER_GAMMA = 0.5772156649015329

F32_UNIT_ROUNDOFF = 2.0 ** -24

# a row's score may differ from the float64 reference by this much from
# float32 sums of its path lengths alone (they stay within about 3e-7)
ROW_TOLERANCE = 1e-5

# rows a block: an extended block's [rows, slots] float64 products take
# 0.5 GB; a standard block's temporaries a few hundred MB
BLOCK_ROWS = {"standard": 1 << 22, "extended": 1 << 18}


def c_of(n: torch.Tensor) -> torch.Tensor:
    """``c(n)`` in float64, 0 where ``n <= 1``."""
    n = n.double()
    safe = torch.clamp(n, min=2.0)
    c = 2.0 * (torch.log(safe - 1.0) + EULER_GAMMA) - 2.0 * (safe - 1.0) / safe
    return torch.where(n > 1, c, torch.zeros_like(c))


def _leaf_values(num_instances: torch.Tensor) -> torch.Tensor:
    """``depth + c(n)`` at leaves, float64 ``[T, M]`` (0 at internal slots)."""
    m = num_instances.shape[1]
    # heap slot i lies at depth bit_length(i + 1) - 1, counted in integers
    depth = torch.tensor([(i + 1).bit_length() - 1 for i in range(m)], dtype=torch.float64,
                         device=num_instances.device)
    zero = torch.zeros((), dtype=torch.float64, device=num_instances.device)
    return torch.where(num_instances >= 0, depth[None, :] + c_of(num_instances), zero)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32 (10 mantissa bits, to nearest)."""
    bits = x.float().contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1FFF
    return rounded.view(torch.float32)


class Scored(NamedTuple):
    scores: torch.Tensor  # f64 [N]
    visited: torch.Tensor  # i64 [N]: internal nodes visited over all trees
    tolerance: torch.Tensor  # f64 [N]: how far a float32 program's score may lie from ``scores``


def _walk_standard(forest: dict, X: torch.Tensor, h: int, precision: Optional[str]):
    feature = forest["feature"].long()
    thr = forest["threshold"]
    if precision == "bf16":
        X = X.to(torch.bfloat16)
        thr = thr.to(torch.bfloat16)
    leaf = _leaf_values(forest["num_instances"])
    n = X.shape[0]
    total = torch.zeros(n, dtype=torch.float64, device=X.device)
    visited = torch.zeros(n, dtype=torch.int64, device=X.device)
    for t in range(feature.shape[0]):
        node = torch.zeros(n, dtype=torch.long, device=X.device)
        for _ in range(h):
            f = feature[t][node]
            inside = f >= 0
            xv = X.gather(1, f.clamp(min=0)[:, None])[:, 0]
            node = torch.where(inside, 2 * node + 1 + (xv >= thr[t][node]).long(), node)
            visited += inside
        total += leaf[t][node]
    # a float32 compare of float32 values is exact: no decision is near a tie
    return total, visited, torch.zeros(n, dtype=torch.float64, device=X.device)


def _walk_extended(forest: dict, X: torch.Tensor, h: int, precision: Optional[str]):
    idx, w, off = forest["indices"].long(), forest["weights"], forest["offset"]
    internal_slots = (1 << h) - 1  # slots of levels 0..h-1, the only ones that split
    t_n, _, k = idx.shape
    f_n = X.shape[1]
    leaf = _leaf_values(forest["num_instances"])
    is_leaf = forest["num_instances"] >= 0
    inf = torch.tensor(float("inf"), dtype=torch.float64, device=X.device)
    leaf_range = torch.where(is_leaf, leaf, -inf).amax(1) - torch.where(is_leaf, leaf, inf).amin(1)
    gamma = k * F32_UNIT_ROUNDOFF / (1.0 - k * F32_UNIT_ROUNDOFF)
    n = X.shape[0]
    if precision == "tf32":
        Xd, dtype = round_tf32(X), torch.float32
    else:
        Xd, dtype = X.double(), torch.float64
    total = torch.zeros(n, dtype=torch.float64, device=X.device)
    spread = torch.zeros(n, dtype=torch.float64, device=X.device)
    visited = torch.zeros(n, dtype=torch.int64, device=X.device)
    rows = torch.arange(n, device=X.device)
    for t in range(t_n):
        inside_t = idx[t, :internal_slots, 0] >= 0
        dense = torch.zeros((internal_slots, f_n), dtype=torch.float64, device=X.device)
        used = idx[t, :internal_slots] >= 0
        wt = torch.where(used, w[t, :internal_slots].double(), torch.zeros((), dtype=torch.float64, device=X.device))
        dense.scatter_add_(1, idx[t, :internal_slots].clamp(min=0), wt)
        if precision == "tf32":
            dense = round_tf32(dense.float())
        dots = (Xd @ dense.to(dtype).T).double()  # [N, internal slots]
        # a float32 dot of k terms lies within gamma_k * sum |w x| of the exact one
        margins = gamma * (Xd.abs() @ dense.abs().to(dtype).T).double() if precision is None else None
        near_tie = torch.zeros(n, dtype=torch.bool, device=X.device)
        node = torch.zeros(n, dtype=torch.long, device=X.device)
        for _ in range(h):
            slot = node.clamp(max=internal_slots - 1)
            inside = inside_t[slot] & (node < internal_slots)
            d = dots[rows, slot] - off[t][node].double()
            if margins is not None:
                near_tie |= inside & (d.abs() <= margins[rows, slot])
            node = torch.where(inside, 2 * node + 1 + (d >= 0).long(), node)
            visited += inside
        total += leaf[t][node]
        spread += torch.where(near_tie, leaf_range[t], torch.zeros((), dtype=torch.float64, device=X.device))
    return total, visited, spread


def score(forest: dict, X: torch.Tensor, *, max_samples: int, precision: Optional[str] = None) -> Scored:
    """Reference scores (float64) and visited-node counts of every row of
    ``X`` (``f32[N, F]``, a tensor or a NumPy array anywhere), in blocks of
    :data:`BLOCK_ROWS` moved to the device the forest arrays are on. ``forest``
    holds torch tensors: ``feature``, ``threshold``, ``num_instances``
    (standard) or ``indices``, ``weights``, ``offset``, ``num_instances``
    (extended)."""
    extended = "indices" in forest
    m = forest["num_instances"].shape[1]
    h = int(math.log2(m + 1)) - 1
    t_n = forest["num_instances"].shape[0]
    walk = _walk_extended if extended else _walk_standard
    block_rows = BLOCK_ROWS["extended" if extended else "standard"]
    c_n = float(c_of(torch.tensor(float(max_samples))))
    device = forest["num_instances"].device
    scores, visited, tolerance = [], [], []
    with torch.no_grad():
        for start in range(0, X.shape[0], block_rows):
            block = torch.as_tensor(X[start:start + block_rows]).to(device, torch.float32)
            total, v, spread = walk(forest, block, h, precision)
            mean, slack = total / t_n, spread / t_n
            scores.append(torch.exp2(-mean / c_n))
            visited.append(v)
            tolerance.append(ROW_TOLERANCE + torch.exp2(-(mean - slack) / c_n) - torch.exp2(-(mean + slack) / c_n))
    if not scores:
        empty = torch.zeros(0, dtype=torch.float64, device=device)
        return Scored(empty, torch.zeros(0, dtype=torch.int64, device=device), empty)
    return Scored(torch.cat(scores), torch.cat(visited), torch.cat(tolerance))


def forest_bytes(forest: dict) -> int:
    """Bytes of the forest's own node fields, each counted once."""
    return int(sum(a.numel() * a.element_size() for a in forest.values()))


def work(forest: dict, rows: int, num_features: int, visited: int) -> tuple:
    """``(operations, bytes)`` the scoring of ``rows`` rows needs: a visited
    internal node costs one compare (standard) or ``2k + 1`` (extended: k
    multiply-adds and a compare), each (row, tree) pair one add; X, the
    forest's node fields and the scores are moved once."""
    extended = "indices" in forest
    t_n = forest["num_instances"].shape[0]
    per_node = 2 * forest["indices"].shape[2] + 1 if extended else 1
    ops = float(visited) * per_node + float(rows) * t_n
    nbytes = float(rows) * num_features * 4 + forest_bytes(forest) + float(rows) * 4
    return ops, nbytes
