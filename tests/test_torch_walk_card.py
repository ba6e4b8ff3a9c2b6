"""The standard walk ``walk_sum`` (``csrc/path_walk.cu``) on the card over
KDDCup99-HTTP forests of one and of many groups of the staged walk, held
bit for bit to its plain version, with the launch each batch took as the
kernel reports it: a 50-tree forest's records are one group, a 1000-tree
forest's about ten, staged in turn; the forests of exactly one full group
and of one tree more cover the seam between two groups; a forest of more
groups than a launch takes continues its sums over launches; a small batch
takes one warp a row either way. The budget itself is read from the
kernel's own choice: 7,232 - 256 F records a tree of a standard forest at
width F on an H100. The EIF kernels, which share the launch, take the row
tile up to 48 features and L1 above.

Needs a CUDA card and skips elsewhere (it imports no JAX)::

    python -m pytest tests/test_torch_walk_card.py -q
"""

from __future__ import annotations

import pathlib
import sys

import numpy as np
import pytest
import torch

from isoforest_tpu_torch.io.interop import extended_forest_from_arrays, forest_from_arrays
from isoforest_tpu_torch.ops import ext_dense, ext_path, ext_walk, walk
from isoforest_tpu_torch.testing import finite_rows, random_extended_forest, random_heap_forest, rows

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


def _first_trees(tables, trees):
    """The forest of ``tables``' first ``trees`` trees."""
    first = ext_path.tree_first_records(tables.roots.cpu().numpy(), tables.records.shape[0])
    return tables._replace(records=tables.records[: first[trees]].contiguous(),
                           roots=tables.roots[:trees].contiguous())


def _bitwise_with_its_launch(tables, X, rows, variant, groups=None):
    x = X[:rows].contiguous()
    got_variant, got_groups = ext_path.variant_and_groups("walk_sum", rows, x.shape[1], tables)
    assert got_variant == variant
    if groups is not None:
        assert got_groups.shape[1] - 1 == groups
    before = dict(ext_path.variant_launches["walk_sum"])
    got = walk.walk_sum(x, tables)
    assert ext_path.variant_launches["walk_sum"] == {**before, variant: before[variant] + 1}
    want = walk.walk_sum_plain(x, tables)
    assert torch.equal(got, want), f"{tables.num_trees} trees, {rows} rows: max |delta| {float((got - want).abs().max())}"
    return got_groups


@pytest.mark.card
@pytest.mark.parametrize("trees,bulk", [(50, "staged"), (1000, "staged")])
def test_walk_sum_is_bitwise_its_plain_version_and_names_its_launch(card, trees, bulk):
    tables, X = _tables(trees, card)
    groups = _bitwise_with_its_launch(tables, X, ROWS, bulk)
    assert (groups.shape[1] - 1 == 1) == (trees == 50)  # 50 trees are one group, 1000 several
    _bitwise_with_its_launch(tables, X, SMALL, "trees")


@pytest.mark.card
@pytest.mark.parametrize("more,groups", [(0, 1), (1, 2)])
def test_the_seam_between_two_groups_is_bitwise(card, more, groups):
    tables, X = _tables(1000, card)
    _, cut = ext_path.variant_and_groups("walk_sum", ROWS, X.shape[1], tables)
    full = int(cut[0, 1])  # the trees of the first group: as many as fit the budget
    _bitwise_with_its_launch(_first_trees(tables, full + more), X, ROWS, "staged", groups)


@pytest.mark.card
def test_a_forest_of_more_groups_than_a_launch_takes_continues_its_sums(card):
    width = 28  # 64 records a group: a height-6 tree (at most 63) each
    rng = np.random.default_rng(SEED)
    tables = walk.walk_tables(forest_from_arrays(*random_heap_forest(rng, 300, 6, width, 0.85), device=card))
    X = torch.from_numpy(rows(rng, ROWS, width)).to(card)
    groups = _bitwise_with_its_launch(tables, X, ROWS, "staged")
    assert groups.shape[1] - 1 > 2 * 16  # csrc/path_walk.cu's kMaxGroups a launch, so three launches or more


@pytest.mark.card
@pytest.mark.parametrize("width", [3, 28, 29])
def test_the_staged_budget_in_records(card, width):
    if "H100" not in torch.cuda.get_device_name(card):
        pytest.skip("the budget stated is an H100's")
    budget = 7232 - 256 * width

    def takes(sizes):
        first = np.concatenate([[0], np.cumsum(sizes)])
        p = ext_path.PathRecords(torch.zeros((int(first[-1]), 4), dtype=torch.int32, device=card),
                                 torch.from_numpy(~first[:-1].astype(np.int32)).to(card),
                                 k=0, chunk_terms=3, height=8, min_features=width)
        variant, groups = ext_path.variant_and_groups("walk_sum", ROWS, width, p)
        return variant, None if groups is None else groups.shape[1] - 1

    if budget > 0:
        assert takes([budget] * 20) == ("staged", 20)  # many trees, each a full group
        assert takes([1] * budget) == ("staged", 1)
        assert takes([1] * (budget + 1)) == ("staged", 2)
    assert takes([max(budget, 0) + 1]) == ("tile", None)  # a single tree over the budget
    if budget <= 0:
        assert takes([1] * 20) == ("tile", None)  # at F = 29 every forest


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
