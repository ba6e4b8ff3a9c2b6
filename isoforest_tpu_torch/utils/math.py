"""Numeric primitives of the standard isolation forest, in PyTorch.

Counterpart of ``isoforest_tpu/utils/math.py``: the same float32 formula
and constants. Path-length normalisers are computed on the CPU, so a
forest's tables hold the same bits on every device (the card's ``logf`` and
the CPU's ``log`` may differ by an ulp); only the final ``exp2`` of a score
runs where the path lengths are.
"""

from __future__ import annotations

import functools
import math

import torch

# Euler-Mascheroni constant in single precision, as the reference's
# ``EulerConstant = 0.5772156649f`` (core/Utils.scala:74).
EULER_GAMMA = 0.5772156649


def avg_path_length(num_instances) -> torch.Tensor:
    """Expected path length ``c(n)`` of an unsuccessful BST search over ``n`` points.

    ``c(n) = 2 * (ln(n - 1) + gamma) - 2 * (n - 1) / n`` for ``n > 1`` and
    ``0`` otherwise, in float32 (golden points: c(2)=0.15443134,
    c(10)=3.7488806). Accepts a scalar, an array or a tensor; returns a
    float32 tensor on the CPU.
    """
    n = torch.as_tensor(num_instances).detach().to("cpu", torch.float32)
    one = torch.tensor(1.0, dtype=torch.float32)
    two = torch.tensor(2.0, dtype=torch.float32)
    gamma = torch.tensor(EULER_GAMMA, dtype=torch.float32)
    safe = torch.maximum(n, two)
    c = two * (torch.log(safe - one) + gamma) - two * (safe - one) / safe
    return torch.where(n > one, c, torch.zeros((), dtype=torch.float32))


@functools.lru_cache(maxsize=64)
def _avg_path_length_value(num_samples: int) -> float:
    """``c(num_samples)`` as a float (exact: a float32 value), computed once
    per sample count; every score call needs it."""
    return float(avg_path_length(num_samples))


def height_limit(num_samples: int) -> int:
    """Tree height limit ``ceil(log2(n))`` (IsolationTree.scala:60-61)."""
    if num_samples < 2:
        return 0
    return int(math.ceil(math.log2(float(num_samples))))


def height_of(max_nodes: int) -> int:
    """Height of a ``max_nodes``-slot implicit heap: ``log2(M + 1) - 1``."""
    return int(math.log2(max_nodes + 1)) - 1


def max_nodes_for(num_samples: int) -> int:
    """Heap slots ``2**(h+1) - 1`` of a tree grown over ``num_samples`` points;
    children of slot ``i`` live at ``2i+1`` / ``2i+2``."""
    return 2 ** (height_limit(num_samples) + 1) - 1


def score_from_path_length(mean_path_length: torch.Tensor, num_samples: int) -> torch.Tensor:
    """Anomaly score ``s = 2^(-E[h(x)] / c(n))`` (IsolationForestModel.scala:135-138).

    ``c(n)`` is a 0-dim tensor on the path lengths' device, so the quotient
    is a true division there (CUDA turns division by a host scalar into a
    multiplication by its reciprocal); it is filled there from its float32
    value, so the call does not wait for a host-to-device copy.
    """
    pl = torch.as_tensor(mean_path_length, dtype=torch.float32)
    c = torch.full((), _avg_path_length_value(int(num_samples)), dtype=torch.float32, device=pl.device)
    return torch.exp2(-pl / c)


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` of float32 tensors with one rounding, as CUDA's
    ``__fmaf_rn`` and the FMA that XLA:CPU contracts a multiply-add into.

    The product is exact in float64 and the sum's rounding error is
    recovered with TwoSum, so the float64 sum rounds to float32 correctly
    even where it lands exactly halfway between two float32 values (where
    a plain float64 emulation would round twice).
    """
    a64, b64, c64 = a.double(), b.double(), c.double()
    p = a64 * b64
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    r = s.float()
    d = s - r.double()
    other = torch.nextafter(r, torch.where(d > 0, float("inf"), float("-inf")).float())
    halfway = torch.isfinite(r) & (d != 0) & (2 * d == other.double() - r.double())
    # at a halfway s, the exact sum lies past s (away from r) iff err has d's sign
    return torch.where(halfway & (err != 0) & ((err > 0) == (d > 0)), other, r)


def slot_depths(max_nodes: int) -> torch.Tensor:
    """Depth of every heap slot, ``f32[M]``."""
    h = height_of(max_nodes)
    return torch.cat(
        [torch.full((1 << lv,), float(lv), dtype=torch.float32) for lv in range(h + 1)]
    )


def leaf_value_table(num_instances, height: int) -> torch.Tensor:
    """``depth + c(numInstances)`` at leaves, 0 elsewhere: ``f32[T, M]`` on the CPU.

    A walk that ends at slot ``m`` contributes exactly this entry
    (IsolationTree.scala:213-229).
    """
    ni = torch.as_tensor(num_instances).detach().to("cpu")
    depth = slot_depths((1 << (height + 1)) - 1)
    return torch.where(
        ni >= 0, depth[None, :] + avg_path_length(ni), torch.zeros((), dtype=torch.float32)
    ).to(torch.float32)
