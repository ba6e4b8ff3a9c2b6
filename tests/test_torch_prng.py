"""The port's threefry streams (``isoforest_tpu_torch/ops/prng.py``) against
``jax.random`` of jax 0.9.0 (``jax_threefry_partitionable=True``), on the CPU.

Every function is held bitwise except :func:`prng.gumbel`: its draws pass
through torch's float32 ``log``, which differs from XLA's by an ulp on
about a fifth of draws. That difference is pinned here (one float32 ulp of
``max(|g|, 1)`` at most, on exactly equal uniforms), and is why growth is
held bitwise only with the reference's own Gumbel draws fed in
(``test_torch_growth.py``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isoforest_tpu_torch.ops import prng
from isoforest_tpu_torch.testing import torch_threads

SEEDS = [0, 1, 42, 2**31 + 5, 2**32 - 1]
TINY = float(np.finfo(np.float32).tiny)


def _key(seed: int):
    return jax.random.PRNGKey(np.uint32(seed)), prng.PRNGKey(seed)


def _same(jax_array, tensor) -> None:
    """Bitwise equality of a jax array and a tensor (floats by their bits)."""
    want = np.asarray(jax_array)
    got = tensor.numpy()
    assert got.shape == want.shape
    if want.dtype == np.float32:
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    else:
        np.testing.assert_array_equal(got.astype(np.int64), want.astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in(seed):
    jk, pk = _key(seed)
    _same(jk, pk)
    for num in (2, 3, 7):
        _same(jax.random.split(jk, num), prng.split(pk, num))
    for data in (0, 7, 2**31 + 3, 2**32 - 1):
        _same(jax.random.fold_in(jk, np.uint32(data)), prng.fold_in(pk, data))


def test_batched_keys_match_vmap():
    jk, pk = _key(3)
    ids = np.arange(10, dtype=np.uint32)
    jkeys = jax.vmap(lambda t: jax.random.fold_in(jk, t))(ids)
    pkeys = prng.fold_in(pk, torch.arange(10))
    _same(jkeys, pkeys)
    _same(jax.vmap(lambda k: jax.random.split(k, 4))(jkeys), prng.split(pkeys, 4))
    _same(jax.vmap(lambda k: jax.random.bits(k, (3, 5)))(jkeys), prng.bits(pkeys, (3, 5)))
    _same(jax.vmap(lambda k: jax.random.permutation(k, 300))(jkeys), prng.permutation(pkeys, 300))


@pytest.mark.parametrize("shape", [(), (5,), (3, 4), (2, 3, 5), (1000,)])
def test_bits(shape):
    for seed in (0, 2**31 + 5):
        jk, pk = _key(seed)
        _same(jax.random.bits(jk, shape), prng.bits(pk, shape))


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-3.7, 11.1), (0.0, 1e-3), (TINY, 1.0), (-1e6, 1e6)])
def test_uniform(lo, hi):
    for seed in SEEDS:
        jk, pk = _key(seed)
        _same(jax.random.uniform(jk, (4096,), jnp.float32, lo, hi), prng.uniform(pk, 4096, lo, hi))


@pytest.mark.parametrize("lo,hi", [(0, 10), (0, 7), (3, 1_000_003), (-5, 2**31 - 1), (0, 1), (5, 5), (9, 2)])
def test_randint(lo, hi):
    for seed in SEEDS:
        jk, pk = _key(seed)
        _same(jax.random.randint(jk, (500,), lo, hi), prng.randint(pk, 500, lo, hi))


def test_randint_per_element_span():
    """Floyd's draws: one key a draw, and a span that grows with it, most
    of them not a power of two."""
    jk, pk = _key(11)
    n, s = 1000, 200
    ids = np.arange(s, dtype=np.int32)
    want = jax.vmap(lambda i: jax.random.randint(jax.random.fold_in(jk, i), (), 0, n - s + i + 1))(ids)
    i = torch.arange(s)
    _same(want, prng.randint(prng.fold_in(pk, i), (), 0, n - s + i + 1))


@pytest.mark.parametrize("n", [1, 5, 1625, 1626, 11_183, 65_537])
def test_permutation(n):
    """One sort round up to n = 1,625, two above; at n >= 2^16 the 32-bit
    sort keys tie, and both sorts keep tied rows in order (stable)."""
    for seed in (0, 2**32 - 1):
        jk, pk = _key(seed)
        _same(jax.random.permutation(jk, n), prng.permutation(pk, n))


def test_gumbel_differs_only_by_log():
    """The uniforms under the Gumbel draws are jax's bit for bit; the draws
    differ from jax's on some of them, by at most one float32 ulp of
    ``max(|g|, 1)`` (near g = 0 that is many ulps of g itself)."""
    jk, pk = _key(1)
    _same(jax.random.uniform(jk, (20_000,), jnp.float32, TINY, 1.0), prng.uniform(pk, 20_000, TINY, 1.0))
    want = np.asarray(jax.random.gumbel(jk, (20_000,), jnp.float32))
    got = prng.gumbel(pk, 20_000).numpy()
    gap = np.abs(got.astype(np.float64) - want)
    unit = np.spacing(np.maximum(np.abs(want), 1).astype(np.float32)).astype(np.float64)
    assert (gap <= unit).all()
    assert 0.0 < (gap > 0).mean() < 0.5


@pytest.fixture
def one_torch_thread():
    with torch_threads(1):
        yield


def _ulps(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """float32 ulps between same-signed values, by their bit patterns."""
    return np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))


def _log1p_arguments() -> np.ndarray:
    rng = np.random.default_rng(0)
    edges = [0.0, -0.0, -1.0, 1e-30, -1e-30, 1e-40, np.inf, -np.inf, np.nan, -1.5, 3e38,
             np.sqrt(2) - 1, -(np.sqrt(2) - 1), np.nextafter(-1, 0)]
    return np.concatenate([rng.uniform(-1, 1, 100_000), rng.uniform(-1e-3, 1e-3, 20_000),
                           -rng.uniform(0, 1, 20_000) ** 2, rng.uniform(0, 100, 20_000), edges]).astype(np.float32)


def test_log1p_is_xlas(one_torch_thread):
    """XLA:CPU's float32 log1p (a Cephes rational function below sqrt(2) - 1,
    its polynomial log of 1 + x above), with its FMAs and its
    denormals-as-zero, bit for bit: both branches, and NaN, inf, -1 and
    subnormal arguments."""
    x = _log1p_arguments()
    want = np.asarray(jax.jit(jnp.log1p)(jnp.asarray(x)))
    got = prng.log1p(torch.from_numpy(x)).numpy()
    same = (got.view(np.int32) == want.view(np.int32)) | (np.isnan(got) & np.isnan(want))
    assert same.all(), x[~same][:5]
    a = np.abs(x[np.isfinite(x)]) + np.float32(1e-40)  # subnormal and normal logs
    _same(jax.jit(jnp.log)(jnp.asarray(a)), prng._log_xla(torch.from_numpy(a)))


def test_erf_inv_and_normal_are_bitwise(one_torch_thread):
    """``erf_inv`` is XLA's ``ErfInv32`` bit for bit, fed jax's own ``w =
    -log1p(-x*x)`` and with the port's ``log1p``; so ``normal`` is jax's.
    The one residue found on the way was torch's CPU ``sqrt``, an ulp off on
    about 0.7% of inputs (the ``w >= 5`` branch takes ``sqrt(w) - 3``):
    ``sqrt_f32`` rounds through float64 instead. (It showed on 1 of 200,000
    draws fed jax's ``w``.)"""
    lo = np.float32(np.nextafter(np.float32(-1), np.float32(0)))
    for seed in (1, 2**31 + 5):
        jk, pk = _key(seed)
        u = np.asarray(jax.random.uniform(jk, (100_000,), jnp.float32, lo, 1.0))
        w = np.asarray(jax.jit(lambda x: -jnp.log1p(-x * x))(jnp.asarray(u)))
        want = jax.lax.erf_inv(jnp.asarray(u))
        _same(want, prng.erf_inv_of_w(torch.from_numpy(u), torch.from_numpy(w)))
        _same(want, prng.erf_inv(torch.from_numpy(u)))
        _same(jax.random.normal(jk, (100_000,), jnp.float32), prng.normal(pk, 100_000))
    jkeys = jax.vmap(lambda t: jax.random.fold_in(jk, t))(np.arange(4, dtype=np.uint32))
    _same(jax.vmap(lambda k: jax.random.normal(k, (3, 7), jnp.float32))(jkeys),
          prng.normal(prng.fold_in(pk, torch.arange(4)), (3, 7)))
    x = np.concatenate([np.float32([-1, 1, 0, -0.0]), u[:1000]])
    _same(jax.lax.erf_inv(jnp.asarray(x)), prng.erf_inv(torch.from_numpy(x)))
    w = np.abs(np.random.default_rng(1).normal(size=100_000)).astype(np.float32) * 20
    _same(jnp.sqrt(jnp.asarray(w)), prng.sqrt_f32(torch.from_numpy(w)))
    assert 0.0 < (torch.sqrt(torch.from_numpy(w)).numpy() != np.sqrt(w)).mean() < 0.05


def test_torch_erfinv_and_log1p_would_be_worse(one_torch_thread):
    """Why ``normal`` carries its own ``erf_inv`` and ``log1p``: on the same
    uniforms ``torch.erfinv`` misses jax's normal on more than half of the
    draws, by tens of ulps, and torch's ``log1p`` alone (under the port's
    ``erf_inv``) on about 1% of them, by up to 3 ulps."""
    jk, pk = _key(1)
    lo = np.float32(np.nextafter(np.float32(-1), np.float32(0)))
    u = prng.uniform(pk, 200_000, float(lo), 1.0)
    want = np.asarray(jax.random.normal(jk, (200_000,), jnp.float32))
    by_torch = (np.float32(np.sqrt(2)) * torch.erfinv(u).numpy()).astype(np.float32)
    gap = _ulps(by_torch, want)
    assert (gap > 0).mean() > 0.5 and gap.max() > 20
    by_torch_log1p = (np.float32(np.sqrt(2)) * prng.erf_inv_of_w(u, -torch.log1p(-u * u)).numpy()).astype(np.float32)
    gap = _ulps(by_torch_log1p, want)
    assert 0.005 < (gap > 0).mean() < 0.02 and gap.max() == 3
