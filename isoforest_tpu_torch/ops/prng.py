"""jax's threefry2x32 random streams in PyTorch, bit for bit.

A copy of the scheme of jax 0.9.0 with ``jax_threefry_partitionable=True``
(jax's default there), so a fit on the card draws exactly the bags, feature
subsets and split thresholds the JAX package draws from the same seed:

* :func:`PRNGKey` is ``threefry_seed`` (``jax/_src/prng.py``);
* :func:`threefry_2x32` is the 20-round Threefry-2x32 hash;
* :func:`split` hashes the counters ``(0, i)`` (``_threefry_split_foldlike``
  over ``iota_2x32_shape``), :func:`fold_in` the counter pair ``(0, data)``;
* :func:`bits` is ``bits1 ^ bits2`` of the hash of the flat counters
  (``_threefry_random_bits_partitionable``, 32 bits);
* :func:`uniform`, :func:`randint`, :func:`permutation` and :func:`gumbel`
  follow ``jax/_src/random.py`` (``_uniform``, ``_randint``, ``_shuffle``,
  ``_gumbel`` in mode ``"low"``).

A key is an int64 tensor ``[..., 2]`` holding two 32-bit words; every
function batches over the key's leading axes, so one call draws for every
tree. Words are carried in int64 and masked to 32 bits: threefry needs only
add, rotate and xor, and the one 32-bit product (in :func:`randint`) is
taken in 16-bit halves so no intermediate leaves int64.
"""

from __future__ import annotations

import math
from typing import Sequence, Union

import torch

from ..utils.math import fma_f32

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_FLOAT32_ONE_BITS = 0x3F800000
_FLOAT32_TINY = torch.finfo(torch.float32).tiny

Shape = Union[int, Sequence[int]]


def _shape(shape: Shape) -> tuple:
    return (shape,) if isinstance(shape, int) else tuple(shape)


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """A key from an integer seed: the words ``(seed >> 32, seed & 0xFFFFFFFF)``,
    as jax builds it from a 64-bit seed (a 32-bit seed has a zero high word)."""
    seed = int(seed)
    if seed < 0:  # an int32 seed: jax's logical shift leaves a zero high word
        seed &= _MASK
    return torch.tensor([(seed >> 32) & _MASK, seed & _MASK], dtype=torch.int64, device=device)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry_2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor):
    """The Threefry-2x32 hash of the counter pairs ``(x1, x2)`` under the key
    ``(k1, k2)``; all four broadcast. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x1, x2


def _words(key: torch.Tensor, ndim: int):
    """The key's two words, with ``ndim`` trailing axes to broadcast over."""
    view = key.shape[:-1] + (1,) * ndim
    return key[..., 0].reshape(view), key[..., 1].reshape(view)


def _counters(shape: tuple, device) -> tuple:
    """``iota_2x32_shape``: the flat index of every element as (hi, lo) words."""
    n = math.prod(shape)
    lo = torch.arange(n, dtype=torch.int64, device=device)
    return (lo >> 32).reshape(shape), (lo & _MASK).reshape(shape)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``num`` new keys from each key: ``[..., 2]`` -> ``[..., num, 2]``."""
    k1, k2 = _words(key, 1)
    hi, lo = _counters((num,), key.device)
    b1, b2 = threefry_2x32(k1, k2, hi, lo)
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """Fold a 32-bit integer (or a tensor of them, broadcast against the
    key's leading axes) into a key: the hash of the counters ``(0, data)``."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _MASK
    b1, b2 = threefry_2x32(key[..., 0], key[..., 1], torch.zeros_like(data), data)
    return torch.stack([b1, b2], dim=-1)


def bits(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """Uniform 32-bit words ``[..., *shape]`` (int64 holding uint32 values)."""
    shape = _shape(shape)
    k1, k2 = _words(key, len(shape))
    hi, lo = _counters(shape, key.device)
    b1, b2 = threefry_2x32(k1, k2, hi, lo)
    return b1 ^ b2


def _unit_floats(words: torch.Tensor) -> torch.Tensor:
    """float32 in [0, 1) from the top 23 bits of each word, exactly."""
    mantissa = (words >> 9) | _FLOAT32_ONE_BITS
    return mantissa.to(torch.int32).view(torch.float32) - 1.0


def uniform(key: torch.Tensor, shape: Shape, minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """float32 uniform in ``[minval, maxval)``: ``floats * (max - min) + min``
    with one rounding (XLA:CPU contracts it into an FMA), clamped below at
    ``minval``, as ``jax.random.uniform``."""
    floats = _unit_floats(bits(key, shape))
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, fma_f32(floats, hi - lo, lo))


def _mul32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a * b mod 2^32`` of 32-bit words without leaving int64."""
    return (a * (b & 0xFFFF) + (((a * (b >> 16)) & 0xFFFF) << 16)) & _MASK


def randint(key: torch.Tensor, shape: Shape, minval, maxval) -> torch.Tensor:
    """int32 in ``[minval, maxval)`` (``jax.random.randint``): two words a
    draw, folded into the span as ``(hi % span) * (2^32 % span) + lo % span``.
    ``minval``/``maxval`` are ints or int tensors broadcast against
    ``[..., *shape]``; both must fit int32."""
    shape = _shape(shape)
    k = split(key)
    higher, lower = bits(k[..., 0, :], shape), bits(k[..., 1, :], shape)
    dev = key.device
    minval = torch.as_tensor(minval, dtype=torch.int64, device=dev)
    maxval = torch.as_tensor(maxval, dtype=torch.int64, device=dev)
    span = torch.where(maxval <= minval, torch.ones_like(maxval), (maxval - minval) & _MASK)
    multiplier = (1 << 16) % span
    multiplier = _mul32(multiplier, multiplier) % span
    offset = ((_mul32(higher % span, multiplier) + lower % span) & _MASK) % span
    return (minval + offset).to(torch.int32)


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """A random permutation of ``0..n-1`` per key, ``int64 [..., n]``
    (``jax.random.permutation`` of an int): ``ceil(3 ln n / ln(2^32 - 1))``
    rounds of a stable sort on fresh 32-bit words."""
    rounds = int(math.ceil(3 * math.log(max(1, n)) / math.log(_MASK)))
    x = torch.arange(n, dtype=torch.int64, device=key.device).expand(*key.shape[:-1], n)
    for _ in range(rounds):
        k = split(key)
        key, sub = k[..., 0, :], k[..., 1, :]
        order = torch.sort(bits(sub, (n,)), dim=-1, stable=True).indices
        x = x.gather(-1, order)
    return x


def gumbel(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """float32 standard Gumbel draws, ``-log(-log(u))`` for ``u`` uniform in
    ``[tiny, 1)`` (``jax.random.gumbel``, mode ``"low"``). torch's ``log``
    may differ from XLA's by an ulp, so these are not bitwise jax's."""
    return -torch.log(-torch.log(uniform(key, shape, _FLOAT32_TINY, 1.0)))
