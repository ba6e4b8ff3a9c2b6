"""How the path-walk kernels' launches are counted by the launch each took
(``csrc/path_walk.cu`` reports it: ``staged``, ``tile``, ``global`` or
``trees``), how the host cuts a standard forest into the staged walk's
groups of whole trees and passes them, and what a scoring call records of
it on its ``score_matrix`` span, on the CPU with the kernel library
stubbed: the stub's entries report a launch as the real ones do and launch
nothing."""

from __future__ import annotations

import ctypes
import pathlib
import sys
import types

import numpy as np
import pytest
import torch

from isoforest_tpu_torch import IsolationForest
from isoforest_tpu_torch.ops import _build, ext_path, walk
from isoforest_tpu_torch.telemetry import spans

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import spec  # noqa: E402
from portbench import trace as bench_trace  # noqa: E402


class _Stub:
    """The path-walk library's entries: each reports ``code`` (the staged
    walk's budget query: ``budget``) through its last argument (a
    ``ctypes.byref`` of an int), as the built ones do."""

    def __init__(self, code: int) -> None:
        self.code = code
        self.budget = 1 << 20
        self.calls = []

    def _report(self, name, args):
        self.calls.append((name, args))
        args[-1]._obj.value = self.budget if name == "walk_staged_budget" else self.code
        return 0

    def named(self, name):
        return [args for called, args in self.calls if called == name]

    def __getattr__(self, name):
        if name in ext_path.SIGNATURES:
            return lambda *args: self._report(name, args)
        raise AttributeError(name)


@pytest.fixture
def stub(monkeypatch):
    lib = _Stub(ext_path.VARIANTS.index("tile"))
    monkeypatch.setattr(_build, "load", lambda name, signatures: lib)
    monkeypatch.setattr(ext_path, "_BUDGETS", {})
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: types.SimpleNamespace(cuda_stream=0))
    return lib


def _tables():
    X = np.random.default_rng(3).normal(size=(600, 3)).astype(np.float32)
    model = IsolationForest(num_estimators=5, max_samples=64.0, random_seed=3, device="cpu").fit(X)
    return walk.walk_tables(model.forest), torch.from_numpy(X)


def test_every_entry_takes_a_pointer_to_the_launch_it_reports():
    for name in ext_path.KERNELS:
        assert ext_path.SIGNATURES[name][-1] is ctypes.c_void_p and len(ext_path.SIGNATURES[name]) == 15
        assert ext_path.SIGNATURES[name][10:12] == (ctypes.c_void_p, ctypes.c_int)  # the groups and their count
    assert ext_path.SIGNATURES["path_variant"][-1] is ctypes.c_void_p
    assert ext_path.SIGNATURES["walk_staged_budget"] == (ctypes.c_int, ctypes.c_void_p)
    assert set(ext_path.launches) == set(ext_path.KERNELS) == set(ext_path.variant_launches)
    assert ext_path.VARIANTS == ("staged", "tile", "global", "trees")


@pytest.mark.parametrize("variant", ["staged", "tile", "global", "trees"])
def test_a_launch_is_counted_in_all_and_by_the_launch_it_took(stub, variant):
    tables, X = _tables()
    stub.code = ext_path.VARIANTS.index(variant)
    total, by_variant = ext_path.launches["walk_sum"], dict(ext_path.variant_launches["walk_sum"])
    series = ext_path._WALK_LAUNCHES_TOTAL.value(kernel="walk_sum", variant=variant)
    ext_path.launch("walk_sum", X, tables)
    assert ext_path.launches["walk_sum"] == total + 1
    assert ext_path.variant_launches["walk_sum"] == {**by_variant, variant: by_variant[variant] + 1}
    assert ext_path._WALK_LAUNCHES_TOTAL.value(kernel="walk_sum", variant=variant) == series + 1


def test_the_small_batch_choice_is_passed_and_no_rows_launch_nothing(stub):
    tables, X = _tables()
    ext_path.launch("walk_sum", X, tables)
    ext_path.launch("walk_sum", X, tables, tree_parallel=False)
    big = X.repeat(ext_path.TREE_PARALLEL_MAX_ROWS["walk_sum"] // X.shape[0] + 1, 1)
    ext_path.launch("walk_sum", big, tables)
    assert [args[9] for args in stub.named("walk_sum")] == [1, 0, 0]
    before = ext_path.launches["walk_sum"]
    assert ext_path.launch("walk_sum", X[:0], tables).shape == (0,)
    assert len(stub.named("walk_sum")) == 3 and ext_path.launches["walk_sum"] == before


def test_the_variant_query_passes_the_records_and_the_small_batch_choice(stub):
    tables, _ = _tables()
    stub.code = ext_path.VARIANTS.index("staged")
    assert ext_path.launch_variant("walk_sum", 1 << 19, 3, tables) == "staged"
    assert stub.calls[-1][0] == "path_variant"
    assert stub.calls[-1][1][:6] == (1 << 19, 3, tables.records.shape[0], tables.num_trees, 0, 0)
    stub.code = ext_path.VARIANTS.index("trees")
    assert ext_path.launch_variant("walk_sum", 1000, 3, tables) == "trees"
    assert stub.calls[-1][1][5] == 1


def test_span_attributes_name_the_bytes_and_the_variant(stub):
    tables, _ = _tables()
    nbytes = tables.records.shape[0] * 16
    assert ext_path.span_attrs("walk_sum", tables, 5000, 3, torch.device("cpu")) == {
        "walk_records_bytes": nbytes, "walk_variant": "plain", "walk_groups": 0}
    stub.code = ext_path.VARIANTS.index("tile")
    assert ext_path.span_attrs("walk_sum", tables, 1 << 19, 3, torch.device("cuda")) == {
        "walk_records_bytes": nbytes, "walk_variant": "tile", "walk_groups": 0}
    assert ext_path.span_attrs("walk_sum", tables, 0, 3, torch.device("cuda")) == {"walk_records_bytes": nbytes}


@pytest.mark.parametrize("strategy,attrs", [("walk", True), ("dense", False)])
def test_a_walk_call_records_them_on_its_score_matrix_span(strategy, attrs):
    X = np.random.default_rng(4).normal(size=(700, 3)).astype(np.float32)
    model = IsolationForest(num_estimators=6, max_samples=64.0, random_seed=4, device="cpu").fit(X)
    model.score(X, strategy=strategy)
    record = spans.records("score_matrix")[-1]
    assert record.attrs["strategy"] == strategy
    if attrs:
        tables = walk.walk_tables(model.forest)
        assert record.attrs["walk_records_bytes"] == tables.records.numel() * 4
        assert record.attrs["walk_variant"] == "plain"
        assert record.attrs["walk_groups"] == 0  # the plain version stages nothing
    else:
        assert not {"walk_variant", "walk_records_bytes", "walk_groups"} & set(record.attrs)


def test_the_staged_share_reader_reads_the_counter_over_the_window(stub):
    tables, X = _tables()
    reader = spec.reader("walk_staged_share.resident")
    ctx = {"counters_before": bench_trace.counters()}
    for variant in ("staged", "staged", "staged", "trees"):
        stub.code = ext_path.VARIANTS.index(variant)
        ext_path.launch("walk_sum", X, tables)
    stub.code = ext_path.VARIANTS.index("tile")
    ext_path.launch("ext_walk_sum", X, tables._replace(k=1))  # another kernel: not read
    ctx["counters_after"] = bench_trace.counters()
    assert reader.read(ctx) == pytest.approx(75.0)
    ctx["counters_before"] = ctx["counters_after"]
    assert reader.read(ctx) is None  # no walk_sum launch in the window


def _first_records(sizes):
    """Tree first records of a forest whose trees hold ``sizes`` records."""
    return np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)


def _check_groups(groups, first, budget):
    trees, recs = groups.astype(np.int64)
    assert groups.dtype == np.int32 and groups.flags.c_contiguous
    assert trees[0] == 0 and trees[-1] == len(first) - 1 and (np.diff(trees) > 0).all()  # whole trees, in order
    assert (recs == first[trees]).all()  # each group starts at its first tree's first record
    assert recs[0] == 0 and recs[-1] == first[-1]  # every record once: the groups abut, from 0 to the end
    assert (np.diff(recs) <= budget).all()
    # greedy: no group could have taken its next tree as well
    assert all(first[trees[g + 1] + 1] - recs[g] > budget for g in range(len(trees) - 2))


@pytest.mark.parametrize("seed,budget", [(0, 64), (1, 300), (2, 1000), (3, 6464), (4, 10 ** 6)])
def test_groups_are_whole_consecutive_trees_covering_every_record_within_the_budget(seed, budget):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(0, min(budget, 255) + 1, size=int(rng.integers(1, 1500)))
    first = _first_records(sizes)
    groups = ext_path.walk_groups(first, budget)
    _check_groups(groups, first, budget)
    if sizes.sum() <= budget:
        assert groups.shape == (2, 2)  # a forest within the budget is one group


def test_single_leaf_trees_join_a_group_and_a_tree_over_the_budget_stages_nothing():
    first = _first_records([0, 5, 0, 0, 7, 0, 3, 0])
    groups = ext_path.walk_groups(first, 8)
    _check_groups(groups, first, 8)
    assert groups.tolist() == [[0, 4, 6, 8], [0, 5, 12, 15]]
    assert ext_path.walk_groups(_first_records([0, 0, 0]), 0).tolist() == [[0, 3], [0, 0]]
    assert ext_path.walk_groups(first, 6) is None  # tree 4 holds 7 records
    assert ext_path.walk_groups(first, -1) is None  # no group fits the card at this width


def test_tree_first_records_follow_the_roots_and_bound_each_trees_codes():
    tables, _ = _tables()
    roots = tables.roots.numpy()
    first = ext_path.tree_first_records(roots, tables.records.shape[0])
    assert first[0] == 0 and first[-1] == tables.records.shape[0] and (np.diff(first) >= 0).all()
    _, left, right, *_ = ext_path.record_fields(tables)
    for t, root in enumerate(roots):
        assert root >= 0 or ~root == first[t]
        inside = np.arange(first[t], first[t + 1])
        children = np.concatenate([left.numpy()[inside], right.numpy()[inside]])
        internal = ~children[children < 0]
        assert ((internal >= first[t]) & (internal < first[t + 1])).all()
    leafy = np.array([~0, 5, ~3, 9, 9], np.int32)  # trees 1, 3 and 4 are single leaves
    assert ext_path.tree_first_records(leafy, 6).tolist() == [0, 3, 3, 6, 6, 6]


def _groups_passed(args):
    ptr, count = args
    if count == 0:
        return None
    return np.ctypeslib.as_array(ctypes.cast(ptr, ctypes.POINTER(ctypes.c_int32)), (2 * (count + 1),)).reshape(2, -1)


def test_a_bulk_launch_passes_the_groups_to_the_entry_and_to_the_variant_query(stub):
    tables, X = _tables()
    first = ext_path.tree_first_records(tables.roots.numpy(), tables.records.shape[0])
    stub.budget = int(np.diff(first).max())  # the largest tree fills a group
    want = ext_path.walk_groups(first, stub.budget)
    assert want is not None and want.shape[1] > 2  # more than one group
    big = X.repeat(ext_path.TREE_PARALLEL_MAX_ROWS["walk_sum"] // X.shape[0] + 1, 1)
    ext_path.launch("walk_sum", big, tables)
    ext_path.launch_variant("walk_sum", big.shape[0], 3, tables)
    for name, at in (("walk_sum", 10), ("path_variant", 6)):
        assert np.array_equal(_groups_passed(stub.named(name)[-1][at:at + 2]), want), name
    assert [args[0] for args in stub.named("walk_staged_budget")] == [3]  # asked once for the width
    # a small batch, and an EIF at any size, pass none
    ext_path.launch("walk_sum", X, tables)
    ext_path.launch("ext_walk_sum", big, tables._replace(k=1))
    assert stub.named("walk_sum")[-1][10:12] == (None, 0) and stub.named("ext_walk_sum")[-1][10:12] == (None, 0)
    stub.budget -= 1  # the largest tree over the budget: the standard walk passes none either
    ext_path._BUDGETS.clear()
    ext_path.launch("walk_sum", big, tables)
    assert stub.named("walk_sum")[-1][10:12] == (None, 0)


def test_walk_groups_is_on_the_span_of_a_staged_launch(stub):
    tables, _ = _tables()
    stub.code = ext_path.VARIANTS.index("staged")
    first = ext_path.tree_first_records(tables.roots.numpy(), tables.records.shape[0])
    for budget in (int(np.diff(first).max()), 1 << 20):
        ext_path._BUDGETS.clear()
        stub.budget = budget
        attrs = ext_path.span_attrs("walk_sum", tables, 1 << 19, 3, torch.device("cuda"))
        assert attrs["walk_variant"] == "staged"
        assert attrs["walk_groups"] == ext_path.walk_groups(first, budget).shape[1] - 1
    assert attrs["walk_groups"] == 1  # within the budget: one group
