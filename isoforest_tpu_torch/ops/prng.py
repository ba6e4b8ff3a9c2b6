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
* :func:`uniform`, :func:`randint`, :func:`permutation`, :func:`gumbel` and
  :func:`normal` follow ``jax/_src/random.py`` (``_uniform``, ``_randint``,
  ``_shuffle``, ``_gumbel`` in mode ``"low"``, ``_normal_real``);
* :func:`erf_inv` is the float32 polynomial XLA lowers ``lax.erf_inv`` to
  (Giles' single-precision approximation, ``ErfInv32``), over
  :func:`log1p`, XLA:CPU's own ``log1p`` (a Cephes rational function for
  small arguments, else its polynomial ``log`` of ``1 + x``), so
  :func:`normal` is jax's bit for bit.

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
# jax.random.normal draws u in (-1, 1): its lower bound is nextafter(-1, 0)
_NORMAL_LO = -1.0 + 2.0**-24
_SQRT2_F32 = 1.41421354  # float32(sqrt(2)), as jax rounds np.sqrt(2)

# ErfInv32's coefficients, highest power first: for w = -log1p(-x*x) < 5 in
# w - 2.5, else in sqrt(w) - 3 (XLA's math.cc, CHLO's materializeErfInvF32)
_ERF_INV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
                   -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_LOG_SQRT_HALF = 0.707106781186547524
_LOG_COEFFICIENTS = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,  # chain a
                     -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,  # chain b
                     2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)  # chain c
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375
_LOG1P_SMALL = 0.41421356237309504880  # sqrt(2) - 1
_LOG1P_NUMERATOR = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1, 6.5787325942061044846969e0,
                    2.9911919328553073277375e1, 6.0949667980987787057556e1, 5.7112963590585538103336e1,
                    2.0039553499201281259648e1)
_LOG1P_DENOMINATOR = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1, 2.2176239823732856465394e2,
                      3.0909872225312059774938e2, 2.1642788614495947685003e2, 6.0118660497603843919306e1)
_ERF_INV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
                   -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)

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


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``sqrt``, correctly rounded on every device (through float64,
    which rounds a float32's root once more without error). torch's
    vectorised CPU ``sqrt`` is not: it is an ulp off on about 0.7% of inputs,
    where XLA emits the exact instruction."""
    return torch.sqrt(x.double()).float()


def erf_inv_of_w(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv(x)`` given ``w = -log1p(-x*x)``: the Horner
    steps ``p = c + p * v`` each rounded once (XLA:CPU contracts them into
    FMAs), then ``p * x``; ``|x| == 1`` gives ``x * inf``."""
    lt = w < 5.0

    def coefficient(i: int) -> torch.Tensor:
        return torch.where(lt, _f32(_ERF_INV_W_LT_5[i]), _f32(_ERF_INV_W_GE_5[i]))

    v = torch.where(lt, w - 2.5, sqrt_f32(w) - 3.0)
    p = coefficient(0)
    for i in range(1, len(_ERF_INV_W_LT_5)):
        p = fma_f32(p, v, coefficient(i))
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def _f32(value: float) -> torch.Tensor:
    """A float32 constant as a 0-dim CPU tensor, which torch broadcasts
    against a tensor on any device without a copy."""
    return torch.tensor(value, dtype=torch.float32)


def _log_xla(a: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's float32 ``log`` (Cephes ``logf``, ``polynomial_approximations.cc``)
    with the FMAs its x86 code contracts: ``a = 2^e * m``, ``m`` in
    ``[sqrt(1/2), sqrt(2))``, three interleaved polynomial chains in ``m - 1``."""
    tiny = _FLOAT32_TINY
    b = torch.clamp_min(a, tiny).view(torch.int32)
    e = ((b >> 23) - 127).float() + 1.0
    m = ((b & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    below = m < _LOG_SQRT_HALF
    e = e - below.float()
    x = (m - 1.0) + torch.where(below, m, 0.0)
    z = x * x
    x3 = z * x
    c = _LOG_COEFFICIENTS
    chain_a = fma_f32(fma_f32(x, _f32(c[0]), _f32(c[1])), x, _f32(c[2]))
    chain_b = fma_f32(fma_f32(x, _f32(c[3]), _f32(c[4])), x, _f32(c[5]))
    chain_c = fma_f32(fma_f32(x, _f32(c[6]), _f32(c[7])), x, _f32(c[8]))
    y = fma_f32(fma_f32(fma_f32(chain_a, x3, chain_b), x3, chain_c), x3, e * _LOG_Q1)
    r = fma_f32(e, _f32(_LOG_Q2), (x - z * 0.5) + y)
    r = torch.where(a > 0, r, float("nan"))  # negative or NaN
    # XLA:CPU runs with denormals as zero: log of a subnormal is -inf too
    r = torch.where(a.abs() < tiny, float("-inf"), r)
    return torch.where(a == float("inf"), a, r)


def _horner(x: torch.Tensor, coefficients, start: torch.Tensor) -> torch.Tensor:
    """``p = p * x + c`` over ``coefficients`` from ``start``, each step an FMA."""
    p = start
    for c in coefficients:
        p = fma_f32(p, x, _f32(c))
    return p


def log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA:CPU's float32 ``log1p`` bit for bit: for ``|x| < sqrt(2) - 1`` the
    Cephes rational form ``x - x^2/2 + x^3 * P(x)/Q(x)``, else
    :func:`_log_xla` of ``1 + x`` (torch's own ``log1p`` is an ulp off on
    about 8% of the arguments ``normal`` draws)."""
    x = torch.where(x.abs() < _FLOAT32_TINY, x * 0.0, x)  # XLA:CPU reads subnormals as zero
    x2 = x * x
    zero_x = x * 0.0  # each polynomial starts 0 * x + c, unfused: the product has two uses
    num = _horner(x, _LOG1P_NUMERATOR[1:], zero_x + _LOG1P_NUMERATOR[0])
    den = _horner(x, _LOG1P_DENOMINATOR[1:], zero_x + _LOG1P_DENOMINATOR[0])
    small = x + fma_f32(x2, _f32(-0.5), (x * x2) * (num / den))
    return torch.where(x.abs() < _LOG1P_SMALL, small, _log_xla(x + 1.0))


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """float32 inverse error function, as XLA computes ``lax.erf_inv``:
    :func:`erf_inv_of_w` of ``w = -log1p(-x*x)``."""
    return erf_inv_of_w(x, -log1p(-x * x))


def normal(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """float32 standard normal draws ``sqrt(2) * erf_inv(u)`` for ``u``
    uniform in ``(-1, 1)`` (``jax.random.normal``), jax's bit for bit."""
    return _SQRT2_F32 * erf_inv(uniform(key, shape, _NORMAL_LO, 1.0))
