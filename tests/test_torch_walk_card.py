"""The standard walk ``walk_sum`` (``csrc/path_walk.cu``) on the card over
KDDCup99-HTTP forests on either side of the staged walk's shared-memory
budget, held bit for bit to its plain version, with the launch each batch
took as the kernel reports it: a 50-tree forest's records fit the staged
walk, a 1000-tree forest's do not and take the row tile with its records
through __ldg; a small batch takes one warp a row either way. The budget
itself is read from the kernel's own choice: 7,232 - 256 F records of a
standard forest at width F on an H100. The EIF kernels, which share the
launch, take the row tile up to 48 features and L1 above.

Needs a CUDA card and skips elsewhere (it imports no JAX)::

    python -m pytest tests/test_torch_walk_card.py -q
"""

from __future__ import annotations

import pathlib
import sys

import numpy as np
import pytest
import torch

from isoforest_tpu_torch.io.interop import extended_forest_from_arrays
from isoforest_tpu_torch.ops import ext_dense, ext_path, ext_walk, walk
from isoforest_tpu_torch.testing import finite_rows, random_extended_forest, rows

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import inputs, spec  # noqa: E402

SEED = 2 ** 31 + 23
ROWS = 1 << 19  # a chunk of the executor: enough rows for every SM's two staged blocks
SMALL = 4096  # below the small-batch launch's row count


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _tables(trees, device):
    config = dict(spec.load_cell("kddhttp-std1k.resident-10m").config, numEstimators=trees)
    model = inputs.build_model(config, inputs.grow_forest(config, seed=SEED, device=device), device)
    X = inputs.scored_rows(config, ROWS, seed=SEED, device=device, place="device")
    return walk.walk_tables(model.forest), X


@pytest.mark.card
@pytest.mark.parametrize("trees,bulk", [(50, "staged"), (1000, "tile")])
def test_walk_sum_is_bitwise_its_plain_version_and_names_its_launch(card, trees, bulk):
    tables, X = _tables(trees, card)
    for rows, variant in ((ROWS, bulk), (SMALL, "trees")):
        x = X[:rows].contiguous()
        assert ext_path.launch_variant("walk_sum", rows, x.shape[1], tables) == variant
        before = dict(ext_path.variant_launches["walk_sum"])
        got = walk.walk_sum(x, tables)
        assert ext_path.variant_launches["walk_sum"] == {**before, variant: before[variant] + 1}
        want = walk.walk_sum_plain(x, tables)
        assert torch.equal(got, want), f"{trees} trees, {rows} rows: max |delta| {float((got - want).abs().max())}"


@pytest.mark.card
@pytest.mark.parametrize("width", [3, 28, 29])
def test_the_staged_budget_in_records(card, width):
    if "H100" not in torch.cuda.get_device_name(card):
        pytest.skip("the budget stated is an H100's")
    budget = 7232 - 256 * width

    def takes(records):
        p = ext_path.PathRecords(torch.zeros((records, 4), dtype=torch.int32), torch.zeros(1, dtype=torch.int32),
                                 k=0, chunk_terms=3, height=8, min_features=width)
        return ext_path.launch_variant("walk_sum", ROWS, width, p)

    if budget > 0:
        assert takes(budget) == "staged"
    assert takes(max(budget, 0) + 1) == "tile"


@pytest.mark.card
@pytest.mark.parametrize("features,k,bulk", [(6, 6, "tile"), (274, 9, "global")])
def test_the_eif_path_kernels_name_their_launch_and_stay_bitwise(card, features, k, bulk):
    rng = np.random.default_rng(7000 + features)
    forest = extended_forest_from_arrays(*random_extended_forest(
        rng, 20, 6, features, k, intercepts=finite_rows(rng, 16, features), unused_p=0.3), device=card)
    X = torch.from_numpy(rows(rng, 70_000, features)).to(card)
    kernels = {
        "ext_walk_sum": (ext_walk.walk_tables_extended(forest), ext_walk.ext_walk_sum, ext_walk.ext_walk_sum_plain),
        "ext_sparse_mean": (ext_dense.sparse_path_records(forest), ext_dense.ext_sparse_mean,
                            lambda x, p: ext_path.path_sum_plain(x, p, paired=False, mean=True)),
    }
    for name, (tables, kernel, plain) in kernels.items():
        for n, variant in ((X.shape[0], bulk), (SMALL, "trees")):
            x = X[:n].contiguous()
            before = dict(ext_path.variant_launches[name])
            got = kernel(x, tables)
            assert ext_path.variant_launches[name] == {**before, variant: before[variant] + 1}, name
            assert torch.equal(got, plain(x, tables)), f"{name}, {n} rows"
