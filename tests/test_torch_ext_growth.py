"""The port's EIF growth (``isoforest_tpu_torch/ops/ext_growth.py``) against
the JAX package's ``grow_extended_forest``, on the CPU.

Fed the JAX package's own per-level draws through growth's seam
(``ext_growth._level_draws``), the port grows the same forest bit for bit:
hyperplane indices, float32 weights and offsets, leaf counts. That needs
XLA:CPU's summation order for the three sums over ``k`` (the norm, the
offset and the routing dot), which changes with ``k``
(``ext_growth.row_dot``): one FMA chain while LLVM unrolls the loop,
eight-lane vector partial sums above that, and windows of 32 above k = 32.
Tie-heavy integer rows make rows tie the offset exactly, so a dot summed in
another order than the offset's routes them otherwise. The port's own
draws are jax's too (``normal`` bitwise, the Gumbel draws within an ulp of
torch's ``log``), so they are also held by growth's invariants.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isoforest_tpu.ops import bagging as jbag
from isoforest_tpu.ops import ext_growth as jeg
from isoforest_tpu.ops import level_window as jlw
from isoforest_tpu_torch.ops import bagging, ext_growth, prng
from isoforest_tpu_torch.testing import extended_growth_invariant_errors, torch_threads


def _reference_draws(tree_keys, h: int, w: int, fc: int, n_chunks: int, k: int):
    """The JAX package's per-level draws of every tree, as its
    ``_grow_one_extended_tree`` draws them: Gumbel ``[T, h+1, n_chunks, W,
    Fc]``, normal weights and intercept uniforms ``[T, h+1, W, k]``."""

    def one(key):
        level_keys = jax.random.split(key, h + 1)
        gumbel, normal, uniform = [], [], []
        for l in range(h + 1):
            k_sub, k_w, k_p = jax.random.split(level_keys[l], 3)
            gumbel.append(jnp.stack([
                jax.random.gumbel(jax.random.fold_in(k_sub, c), (w, fc), jnp.float32) for c in range(n_chunks)
            ]))
            normal.append(jax.random.normal(k_w, (w, k), jnp.float32))
            uniform.append(jax.random.uniform(k_p, (w, k), jnp.float32))
        return jnp.stack(gumbel), jnp.stack(normal), jnp.stack(uniform)

    return tuple(np.array(a) for a in jax.jit(jax.vmap(one))(tree_keys))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


# (features, extension level, features a tree, rows, samples, trees, height):
# k = min(level + 1, features a tree) coordinates a split
CASES = {
    "k1": (6, 0, 6, 400, 64, 3, 5),
    "k2": (6, 1, 6, 400, 64, 3, 5),
    "k6": (6, 5, 6, 400, 64, 3, 6),
    "k16": (16, 15, 16, 400, 64, 3, 5),
    "k17": (17, 16, 17, 400, 64, 3, 5),
    "k24": (24, 23, 24, 400, 64, 3, 5),
    "k32": (32, 31, 32, 400, 64, 3, 5),
    "k33": (40, 32, 40, 400, 64, 3, 5),
    "k64": (64, 63, 64, 400, 64, 3, 5),
    "k130_chunks": (130, 129, 130, 300, 32, 3, 5),
    "max_features_half": (6, 5, 3, 400, 64, 4, 6),
}


def _data(features: int, rows: int) -> np.ndarray:
    """Rows drawn from 16 distinct rows of integers in {0, 1, 2}: many nodes
    hold only equal rows, whose dots tie the offset drawn between them."""
    rng = np.random.default_rng(features)
    return rng.integers(0, 3, size=(16, features)).astype(np.float32)[rng.integers(0, 16, rows)]


@pytest.fixture(scope="module", params=list(CASES))
def grown(request):
    """One case grown by the JAX package, its draws, and the port's inputs."""
    f, level, nf, n, s, t, h = CASES[request.param]
    X = _data(f, n)
    k_bag, k_feat, k_grow = jax.random.split(jax.random.PRNGKey(np.uint32(7)), 3)
    bag = jbag.bagged_indices(k_bag, n, s, t, False)
    fidx = jbag.feature_subsets(k_feat, f, nf, t)
    keys = jbag.per_tree_keys(k_grow, t)
    ref = jeg.grow_extended_forest_block(keys, jnp.asarray(X), bag, fidx, height=h, extension_level=level)
    geom = jlw.chunk_features(jnp.zeros((1, nf)))
    draws = _reference_draws(keys, h, 2**h, geom.chunk, geom.n_chunks, min(level + 1, nf))
    _, pk_feat, pk_grow = prng.split(prng.PRNGKey(7), 3)
    inputs = dict(
        tree_keys=bagging.per_tree_keys(pk_grow, t), X=torch.from_numpy(X),
        bag_idx=torch.from_numpy(np.array(bag)), feat_idx=bagging.feature_subsets(pk_feat, f, nf, t),
        height=h, extension_level=level,
    )
    np.testing.assert_array_equal(inputs["feat_idx"].numpy(), np.asarray(fidx))
    return ref, draws, inputs, X, s


def _assert_same_forest(got, ref) -> None:
    for name, a, b in zip(got._fields, got, ref):
        b = np.asarray(b)
        assert a.dtype == torch.from_numpy(b.copy()).dtype, name
        np.testing.assert_array_equal(a.numpy().view(np.int32), b.view(np.int32), err_msg=name)


def test_growth_fed_the_reference_draws_is_bitwise(grown, monkeypatch):
    ref, (gumbel, normal, uniform), inputs, _, _ = grown
    seen = []

    def reference_draws(level_key, l, w, fc, n_chunks, k):
        assert gumbel.shape[2:] == (n_chunks, w, fc) and normal.shape[2:] == (w, k)

        def chunk_gumbel(c):
            seen.append((l, c))
            return torch.from_numpy(gumbel[:, l, c])

        return chunk_gumbel, torch.from_numpy(normal[:, l]), torch.from_numpy(uniform[:, l])

    monkeypatch.setattr(ext_growth, "_level_draws", reference_draws)
    got = ext_growth.grow_extended_forest(**inputs)
    assert seen == [(l, c) for l in range(inputs["height"] + 1) for c in range(gumbel.shape[2])]
    _assert_same_forest(got, ref)


def test_own_draws_are_the_reference_draws_but_for_gumbel_log(grown):
    """Drawn on the same keys, the weights and intercepts are jax's bit for
    bit and the Gumbel draws within one ulp of max(|g|, 1)."""
    _, (gumbel, normal, uniform), inputs, _, _ = grown
    h = inputs["height"]
    level_keys = prng.split(inputs["tree_keys"], h + 1)
    for l in range(h + 1):
        chunk_gumbel, n, u = ext_growth._level_draws(
            level_keys[:, l], l, 2**h, gumbel.shape[-1], gumbel.shape[2], normal.shape[-1])
        np.testing.assert_array_equal(n.numpy().view(np.int32), normal[:, l].view(np.int32))
        np.testing.assert_array_equal(u.numpy().view(np.int32), uniform[:, l].view(np.int32))
        for c in range(gumbel.shape[2]):
            unit = np.spacing(np.maximum(np.abs(gumbel[:, l, c]), 1)).astype(np.float64)
            assert (np.abs(chunk_gumbel(c).numpy() - gumbel[:, l, c].astype(np.float64)) <= unit).all()


def test_own_draws_keep_growths_invariants(grown):
    ref, _, inputs, X, s = grown
    got = ext_growth.grow_extended_forest(**inputs)
    allowed = inputs["feat_idx"].numpy()
    assert extended_growth_invariant_errors(*(a.numpy() for a in got), X, s, allowed) == []
    assert extended_growth_invariant_errors(*(np.asarray(a) for a in ref), X, s, allowed) == []
    if got.k == 1:  # extension level 0: axis-aligned, |w| = 1
        w = got.weights.numpy()[got.is_internal.numpy(), 0]
        assert (np.abs(w) == 1.0).all()
    if X.shape[1] == 130:  # coordinates from all three chunks, never the tail pad
        sub = got.indices.numpy()[got.indices.numpy() >= 0]
        assert sub.max() < 130 and (sub < 64).any() and ((sub >= 64) & (sub < 128)).any() and (sub >= 128).any()


def test_tail_pad_is_never_drawn():
    """F = 70: the last chunk has 6 real and 58 padded columns, which draw
    -inf and are never chosen, while its real columns are."""
    X = torch.from_numpy(np.random.default_rng(6).normal(size=(500, 70)).astype(np.float32))
    tree_keys, bag, fidx = bagging.ensemble_draws(prng.PRNGKey(6), X, num_samples=64, num_trees=32,
                                                  bootstrap=False, num_features=70)
    forest = ext_growth.grow_extended_forest(tree_keys, X, bag, fidx, 6, 5)
    sub = forest.indices.numpy()[forest.indices.numpy() >= 0]
    assert sub.max() < 70 and (sub >= 64).any()


def test_top_k_breaks_ties_as_lax_top_k():
    """``lax.top_k`` puts the lower position first among equal values;
    ``torch.topk`` does not, a stable descending sort does."""
    for row, k in (([1, 3, 2, 3, -np.inf, 3, 0, -np.inf], 4), ([-np.inf] * 8, 3), ([0.5] * 5 + [2.0] * 3, 6)):
        g = np.array([row], np.float32)
        want_v, want_i = jax.lax.top_k(jnp.asarray(g), k)
        got_v, got_i = ext_growth._top_k(torch.from_numpy(g), torch.arange(len(row))[None], k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_fused_growth_is_the_unfused_chain():
    """Growth on ``bagging.ensemble_draws``, which splits the key as
    ``(k_bag, k_feat, k_grow)``, equals bags + subsets + per-tree keys +
    growth."""
    X = torch.from_numpy(_data(6, 700))
    key = prng.PRNGKey(3)
    k_bag, k_feat, k_grow = prng.split(key, 3)
    want = ext_growth.grow_extended_forest(
        bagging.per_tree_keys(k_grow, 5), X, bagging.bagged_indices(k_bag, 700, 32, 5, False),
        bagging.feature_subsets(k_feat, 6, 6, 5), 5, 2,
    )
    tree_keys, bag, fidx = bagging.ensemble_draws(key, X, num_samples=32, num_trees=5, bootstrap=False,
                                                  num_features=6)
    got = ext_growth.grow_extended_forest(tree_keys, X, bag, fidx, 5, 2)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert got.k == 3
