"""The dense-table kernel (``csrc/ext_gemm.cu``) on the card, held bit for
bit to its plain version (``ops/ext_dense.py::ext_dense_mean_plain``) at
every height the dense strategy serves, in the form the wrapper picks and
in every other form the kernel has at that height: each dense-top depth
below the height, and the fully dense form.

The rows are not a multiple of the kernel's 128-row block; every tile mixes
finite rows with rows holding NaN, +inf or -inf (``testing.rows``), so rows
whose x[0] is not finite meet nodes with unused coordinates; offsets are
drawn from half-integer points, so dots tie their offsets exactly.

Needs a CUDA card and skips elsewhere (it imports no JAX, so it runs on a
machine with only the port's requirements)::

    python -m pytest tests/test_torch_ext_dense_card.py -q
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from isoforest_tpu_torch.io.interop import extended_forest_from_arrays
from isoforest_tpu_torch.ops import ext_dense
from isoforest_tpu_torch.testing import finite_rows, random_extended_forest, rows


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("k,features,unused_p", [(33, 40, 0.3), (274, 274, 0.0), (274, 274, 0.3)])
@pytest.mark.parametrize("height", range(0, 11))
def test_kernel_equals_plain_version_bitwise(card, monkeypatch, height, k, features, unused_p):
    rng = np.random.default_rng(9000 + 100 * height + k + int(10 * unused_p))
    X = torch.from_numpy(rows(rng, 333, features)).to(card)
    arrays = random_extended_forest(rng, 7, height, features, k, intercepts=finite_rows(rng, 32, features),
                                    unused_p=unused_p)
    tables = ext_dense.dense_hyperplane_table(extended_forest_from_arrays(*arrays, device=card))
    want = ext_dense.ext_dense_mean_plain(X, tables)
    picked = ext_dense.dense_top_levels(height, tables.weight.shape[1])
    launches, by_top = ext_dense.ext_dense_mean.launches, dict(ext_dense.ext_dense_mean.launches_by_top)
    assert torch.equal(ext_dense.ext_dense_mean(X, tables), want)
    assert ext_dense.ext_dense_mean.launches == launches + 1
    assert ext_dense.ext_dense_mean.launches_by_top[picked] == by_top.get(picked, 0) + 1
    for top in (height, *(t for t in ext_dense.DENSE_TOPS if t < height)):
        monkeypatch.setattr(ext_dense, "dense_top_levels", lambda h, width, top=top: top)
        got = ext_dense.ext_dense_mean(X, tables)
        assert torch.equal(got, want), f"top={top}: max |delta| {float((got - want).abs().max())}"
