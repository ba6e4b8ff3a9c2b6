"""How the path-walk kernels' launches are counted by the launch each took
(``csrc/path_walk.cu`` reports it: ``staged``, ``tile``, ``global`` or
``trees``), and what a scoring call records of it on its ``score_matrix``
span, on the CPU with the kernel library stubbed: the stub's entries report
a launch as the real ones do and launch nothing."""

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
    """The path-walk library's entries: each reports ``code`` through its
    last argument (a ``ctypes.byref`` of an int), as the built ones do."""

    def __init__(self, code: int) -> None:
        self.code = code
        self.calls = []

    def _report(self, name, args):
        self.calls.append((name, args))
        args[-1]._obj.value = self.code
        return 0

    def __getattr__(self, name):
        if name in ext_path.SIGNATURES:
            return lambda *args: self._report(name, args)
        raise AttributeError(name)


@pytest.fixture
def stub(monkeypatch):
    lib = _Stub(ext_path.VARIANTS.index("tile"))
    monkeypatch.setattr(_build, "load", lambda name, signatures: lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: types.SimpleNamespace(cuda_stream=0))
    return lib


def _tables():
    X = np.random.default_rng(3).normal(size=(600, 3)).astype(np.float32)
    model = IsolationForest(num_estimators=5, max_samples=64.0, random_seed=3, device="cpu").fit(X)
    return walk.walk_tables(model.forest), torch.from_numpy(X)


def test_every_entry_takes_a_pointer_to_the_launch_it_reports():
    for name in ext_path.KERNELS:
        assert ext_path.SIGNATURES[name][-1] is ctypes.c_void_p and len(ext_path.SIGNATURES[name]) == 13
    assert ext_path.SIGNATURES["path_variant"][-1] is ctypes.c_void_p
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
    assert [args[9] for _, args in stub.calls] == [1, 0, 0]
    before = ext_path.launches["walk_sum"]
    assert ext_path.launch("walk_sum", X[:0], tables).shape == (0,)
    assert len(stub.calls) == 3 and ext_path.launches["walk_sum"] == before


def test_the_variant_query_passes_the_records_and_the_small_batch_choice(stub):
    tables, _ = _tables()
    stub.code = ext_path.VARIANTS.index("staged")
    assert ext_path.launch_variant("walk_sum", 1 << 19, 3, tables) == "staged"
    assert stub.calls[-1][0] == "path_variant"
    assert stub.calls[-1][1][:5] == (1 << 19, 3, tables.records.shape[0], 0, 0)
    stub.code = ext_path.VARIANTS.index("trees")
    assert ext_path.launch_variant("walk_sum", 1000, 3, tables) == "trees"
    assert stub.calls[-1][1][4] == 1


def test_span_attributes_name_the_bytes_and_the_variant(stub):
    tables, _ = _tables()
    nbytes = tables.records.shape[0] * 16
    assert ext_path.span_attrs("walk_sum", tables, 5000, 3, torch.device("cpu")) == {
        "walk_records_bytes": nbytes, "walk_variant": "plain"}
    stub.code = ext_path.VARIANTS.index("tile")
    assert ext_path.span_attrs("walk_sum", tables, 1 << 19, 3, torch.device("cuda")) == {
        "walk_records_bytes": nbytes, "walk_variant": "tile"}
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
    else:
        assert "walk_variant" not in record.attrs and "walk_records_bytes" not in record.attrs


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
