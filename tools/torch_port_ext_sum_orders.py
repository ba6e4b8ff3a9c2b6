#!/usr/bin/env python3
"""Sweep the EIF growth's summation orders against the JAX package, on the CPU.

For each ``k`` given (default: 1 to 40, 48, 64, 100, 130, 274) this grows a
small fully extended forest (F = k, 3 trees, 64 samples, height 5, rows
drawn from 16 distinct rows of integers in {0, 1, 2}, so many rows tie an
offset) with the JAX package's
``grow_extended_forest`` and with the port's, the port fed the JAX
package's own draws through ``ext_growth._level_draws``, and prints one
JSON line a ``k``: how many slots differ in hyperplane indices, weights
(the norm's order), offsets (the offset's order) and leaf counts (the
routing dot's order, through tied rows). All zero where
``ext_growth.row_dot`` copies XLA:CPU's order at that ``k``.

    JAX_PLATFORMS=cpu python tools/torch_port_ext_sum_orders.py [k ...]
"""

from __future__ import annotations

import json
import os
import pathlib
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from isoforest_tpu.ops import bagging as jbag  # noqa: E402
from isoforest_tpu.ops import ext_growth as jeg  # noqa: E402
from isoforest_tpu.ops import level_window as jlw  # noqa: E402
from isoforest_tpu_torch.ops import bagging, ext_growth, prng  # noqa: E402

TREES, SAMPLES, HEIGHT, ROWS, SEED = 3, 64, 5, 400, 7


def jax_draws(tree_keys, h: int, w: int, fc: int, n_chunks: int, k: int):
    """The JAX package's per-level Gumbel, normal and uniform draws of every tree."""

    def one(key):
        out = ([], [], [])
        for level_key in jax.random.split(key, h + 1):
            k_sub, k_w, k_p = jax.random.split(level_key, 3)
            out[0].append(jnp.stack([jax.random.gumbel(jax.random.fold_in(k_sub, c), (w, fc), jnp.float32)
                                     for c in range(n_chunks)]))
            out[1].append(jax.random.normal(k_w, (w, k), jnp.float32))
            out[2].append(jax.random.uniform(k_p, (w, k), jnp.float32))
        return tuple(jnp.stack(a) for a in out)

    return tuple(np.array(a) for a in jax.jit(jax.vmap(one))(tree_keys))


def sweep(k: int) -> dict:
    rng = np.random.default_rng(k)  # rows from a pool of 16: many nodes hold equal rows, which tie the offset
    X = rng.integers(0, 3, size=(16, k)).astype(np.float32)[rng.integers(0, 16, ROWS)]
    k_bag, k_feat, k_grow = jax.random.split(jax.random.PRNGKey(np.uint32(SEED)), 3)
    bag = jbag.bagged_indices(k_bag, ROWS, SAMPLES, TREES, False)
    fidx = jbag.feature_subsets(k_feat, k, k, TREES)
    keys = jbag.per_tree_keys(k_grow, TREES)
    ref = jeg.grow_extended_forest_block(keys, jnp.asarray(X), bag, fidx, height=HEIGHT, extension_level=k - 1)
    geom = jlw.chunk_features(jnp.zeros((1, k)))
    gumbel, normal, uniform = jax_draws(keys, HEIGHT, 2**HEIGHT, geom.chunk, geom.n_chunks, k)

    def draws(level_key, l, w, fc, n_chunks, kk):
        return (lambda c: torch.from_numpy(gumbel[:, l, c])), torch.from_numpy(normal[:, l]), torch.from_numpy(
            uniform[:, l])

    own = ext_growth._level_draws
    ext_growth._level_draws = draws
    try:
        _, pk_feat, pk_grow = prng.split(prng.PRNGKey(SEED), 3)
        got = ext_growth.grow_extended_forest(bagging.per_tree_keys(pk_grow, TREES), torch.from_numpy(X),
                                              torch.from_numpy(np.array(bag)),
                                              bagging.feature_subsets(pk_feat, k, k, TREES), HEIGHT, k - 1)
    finally:
        ext_growth._level_draws = own
    row = {"k": k}
    for name, a, b in zip(got._fields, got, ref):
        diff = a.numpy().view(np.int32) != np.asarray(b).view(np.int32)
        row[f"{name}_differ"] = int(diff.reshape(TREES, -1, *diff.shape[2:]).any(axis=tuple(range(2, diff.ndim)))
                                    .sum() if diff.ndim > 2 else diff.sum())
    return row


def main() -> int:
    ks = [int(a) for a in sys.argv[1:]] or list(range(1, 41)) + [48, 64, 100, 130, 274]
    for k in ks:
        print(json.dumps(sweep(k)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
