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
