"""The port's level-synchronous growth (``isoforest_tpu_torch/ops/tree_growth.py``,
``ops/level_window.py``) against the JAX package's ``grow_forest``, on the CPU.

Fed the JAX package's own per-level draws through growth's seam
(``tree_growth._level_draws``), the port grows the same forest bit for
bit: split features, leaf counts and float32 thresholds. The port's own
Gumbel draws go through torch's ``log`` (``test_torch_prng.py``), so with
them the forest is held by growth's invariants instead (heap structure,
leaf counts, constant features never chosen, thresholds in range, the
feature subset respected).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isoforest_tpu.ops import bagging as jbag
from isoforest_tpu.ops import level_window as jlw
from isoforest_tpu.ops import tree_growth as jtg
from isoforest_tpu_torch.ops import bagging, level_window, prng, tree_growth
from isoforest_tpu_torch.testing import growth_invariant_errors


def _reference_draws(tree_keys, h: int, w: int, fc: int, n_chunks: int):
    """The JAX package's per-level draws of every tree: Gumbel ``[T, h+1,
    n_chunks, W, Fc]`` and threshold uniforms ``[T, h+1, W]``, drawn as its
    ``_grow_one_tree`` draws them."""

    def one(key):
        level_keys = jax.random.split(key, h + 1)
        gumbel, uniform = [], []
        for l in range(h + 1):
            k_feat, k_thr = jax.random.split(level_keys[l])
            gumbel.append(jnp.stack([
                jax.random.gumbel(jax.random.fold_in(k_feat, c), (w, fc), jnp.float32) for c in range(n_chunks)
            ]))
            uniform.append(jax.random.uniform(k_thr, (w,), jnp.float32))
        return jnp.stack(gumbel), jnp.stack(uniform)

    g, u = jax.jit(jax.vmap(one))(tree_keys)
    return np.array(g), np.array(u)


def _data(features: int, rows: int) -> np.ndarray:
    rng = np.random.default_rng(features)
    X = rng.normal(size=(rows, features)).astype(np.float32)
    if features > 64:
        X[:, 64:80] = 1.5  # a constant block in the second chunk
    return X


# (features, rows, samples, trees, height, features a tree)
CASES = {
    "h0": (6, 500, 16, 4, 0, 6),
    "h1_f1": (1, 500, 2, 4, 1, 1),
    "h8": (6, 2000, 256, 3, 8, 6),
    "f130_chunks": (130, 400, 32, 3, 5, 130),
    "max_features_half": (6, 2000, 64, 4, 6, 3),
}


@pytest.fixture(scope="module", params=list(CASES))
def grown(request):
    """One case grown by the JAX package, and the port's inputs for it."""
    f, n, s, t, h, nf = CASES[request.param]
    X = _data(f, n)
    jkey = jax.random.PRNGKey(np.uint32(7))
    k_bag, k_feat, k_grow = jax.random.split(jkey, 3)
    bag = jbag.bagged_indices(k_bag, n, s, t, False)
    fidx = jbag.feature_subsets(k_feat, f, nf, t)
    keys = jbag.per_tree_keys(k_grow, t)
    ref = jtg.grow_forest_block(keys, jnp.asarray(X), bag, fidx, height=h)
    geom = jlw.chunk_features(jnp.zeros((1, nf)))
    draws = _reference_draws(keys, h, 2**h, geom.chunk, geom.n_chunks)
    _, pk_feat, pk_grow = prng.split(prng.PRNGKey(7), 3)
    inputs = dict(
        tree_keys=bagging.per_tree_keys(pk_grow, t), X=torch.from_numpy(X),
        bag_idx=torch.from_numpy(np.array(bag)), feat_idx=bagging.feature_subsets(pk_feat, f, nf, t), height=h,
    )
    np.testing.assert_array_equal(inputs["feat_idx"].numpy(), np.asarray(fidx))
    return ref, draws, inputs, X, s


def test_growth_fed_the_reference_draws_is_bitwise(grown, monkeypatch):
    ref, (gumbel, uniform), inputs, _, _ = grown
    seen = []

    def reference_draws(level_key, l, w, fc, n_chunks):
        assert gumbel.shape[2:] == (n_chunks, w, fc)

        def chunk_gumbel(c):
            seen.append((l, c))
            return torch.from_numpy(gumbel[:, l, c])

        return chunk_gumbel, torch.from_numpy(uniform[:, l])

    monkeypatch.setattr(tree_growth, "_level_draws", reference_draws)
    got = tree_growth.grow_forest(**inputs)
    assert seen == [(l, c) for l in range(inputs["height"] + 1) for c in range(gumbel.shape[2])]
    np.testing.assert_array_equal(got.feature.numpy(), np.asarray(ref.feature))
    np.testing.assert_array_equal(got.num_instances.numpy(), np.asarray(ref.num_instances))
    np.testing.assert_array_equal(got.threshold.numpy().view(np.int32), np.asarray(ref.threshold).view(np.int32))
    assert got.feature.dtype == torch.int32 and got.threshold.dtype == torch.float32


def test_own_draws_keep_growths_invariants(grown):
    ref, _, inputs, X, s = grown
    got = tree_growth.grow_forest(**inputs)
    allowed = inputs["feat_idx"].numpy()
    assert growth_invariant_errors(*(a.numpy() for a in got), X, s, allowed) == []
    assert growth_invariant_errors(*(np.asarray(a) for a in ref), X, s, allowed) == []
    if X.shape[1] > 64:  # the constant block of the second chunk is never chosen
        assert not np.isin(got.feature.numpy(), np.arange(64, 80)).any()


def test_own_draws_are_the_reference_draws_but_for_log(grown):
    """Drawn on the same keys, the threshold uniforms are jax's bit for bit
    and the Gumbel draws within one ulp of max(|g|, 1)."""
    _, (gumbel, uniform), inputs, _, _ = grown
    h = inputs["height"]
    level_keys = prng.split(inputs["tree_keys"], h + 1)
    for l in range(h + 1):
        chunk_gumbel, u = tree_growth._level_draws(level_keys[:, l], l, 2**h, gumbel.shape[-1], gumbel.shape[2])
        np.testing.assert_array_equal(u.numpy().view(np.int32), uniform[:, l].view(np.int32))
        for c in range(gumbel.shape[2]):
            want = gumbel[:, l, c].astype(np.float64)
            unit = np.spacing(np.maximum(np.abs(gumbel[:, l, c]), 1)).astype(np.float64)
            assert (np.abs(chunk_gumbel(c).numpy() - want) <= unit).all()


@pytest.mark.parametrize("features", [1, 6, 63, 64, 65, 130, 274])
def test_chunk_geometry(features):
    x = np.ones((3, features), np.float32)
    want = jlw.chunk_features(jnp.asarray(x))
    got = level_window.chunk_features(torch.from_numpy(x))
    assert (got.chunk, got.pad, got.n_chunks) == (want.chunk, want.pad, want.n_chunks)
    np.testing.assert_array_equal(got.x.numpy(), np.asarray(want.x))


def test_fused_growth_is_the_unfused_chain():
    """``bagging.ensemble_draws`` splits the key as ``(k_bag, k_feat,
    k_grow)``, so growth on its draws equals bags + subsets + per-tree keys
    + ``grow_forest``; a given bag replaces only the bagging draw."""
    X = torch.from_numpy(_data(6, 700))
    key = prng.PRNGKey(3)
    k_bag, k_feat, k_grow = prng.split(key, 3)
    want = tree_growth.grow_forest(
        bagging.per_tree_keys(k_grow, 5), X, bagging.bagged_indices(k_bag, 700, 32, 5, False),
        bagging.feature_subsets(k_feat, 6, 6, 5), 5,
    )
    tree_keys, bag, fidx = bagging.ensemble_draws(key, X, num_samples=32, num_trees=5, bootstrap=False,
                                                  num_features=6)
    got = tree_growth.grow_forest(tree_keys, X, bag, fidx, 5)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    given = torch.flip(bag, dims=[1])
    drawn = bagging.ensemble_draws(key, X, num_samples=32, num_trees=5, bootstrap=False, num_features=6, bag=given)
    assert drawn[1] is given and torch.equal(drawn[0], tree_keys) and torch.equal(drawn[2], fidx)
