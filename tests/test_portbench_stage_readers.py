"""The benchmark's readers of the program's stage marks, on hand-made
intervals and spans: ``staging_exposed_ms.bulk`` (idle time of the card
inside a chunk's staging stages) and ``dispatch_host_ms.bulk``
(``score_matrix``'s own host work a call)."""

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import spec  # noqa: E402
from portbench import trace as tr  # noqa: E402

EXPOSED = spec.reader("staging_exposed_ms.bulk")
DISPATCH = spec.reader("dispatch_host_ms.bulk")


def kernel(start, end):
    return tr.Interval("k", "kernel", start, end, 0)


def chunk(stages, index=0):
    start, end = stages[0][1], stages[-1][2]
    return tr.SpanRecord("pipeline.chunk", "main", start, end, {"index": index, "stages": stages})


def call(stages):
    return tr.SpanRecord("score_matrix", "main", stages[0][1], stages[-1][2], {"stages": stages})


def ctx(device, spans, rows=2_000_000):
    return {"device": device, "launches": {}, "spans": spans, "w0_ns": 0, "w1_ns": 1000, "rows_scored": rows}


# a chunk from 100 to 400: wait 100-110, pack 110-300, copy 300-310, launch 310-400
CHUNK = [["wait", 100, 110], ["pack", 110, 300], ["copy", 300, 310], ["launch", 310, 400]]


def test_a_gap_inside_pack_counts_and_one_inside_launch_or_outside_does_not():
    # idle: 0-50 (outside any chunk), 150-250 (inside pack), 320-380 (inside
    # launch), 500-1000 (outside)
    device = [kernel(50, 150), kernel(250, 320), kernel(380, 500)]
    got = EXPOSED.read(ctx(device, [chunk(CHUNK)]))
    assert got == pytest.approx(100 / 1e6 / 2)  # 100 ns over 2 million rows, in ms a million rows


def test_a_gap_across_a_stage_boundary_counts_its_overlap_alone():
    # idle 250-350 straddles pack|copy (300) and copy|launch (310): 250-310 counts
    device = [kernel(0, 250), kernel(350, 1000)]
    assert EXPOSED.read(ctx(device, [chunk(CHUNK)])) == pytest.approx(60 / 1e6 / 2)
    # idle 50-120 straddles the chunk's start and wait|pack: 100-120 counts
    device = [kernel(0, 50), kernel(120, 1000)]
    assert EXPOSED.read(ctx(device, [chunk(CHUNK)])) == pytest.approx(20 / 1e6 / 2)


def test_exposed_staging_sums_over_chunks_and_ignores_other_spans():
    second = [["wait", 500, 600], ["pack", 600, 700], ["copy", 700, 710], ["launch", 710, 800]]
    spans = [call([["prepare", 0, 100], ["execute", 100, 800], ["finish", 800, 900]]),
             chunk(CHUNK), chunk(second, index=1)]
    device = [kernel(0, 200), kernel(650, 1000)]  # idle 200-650
    # 200-310 of the first chunk, 500-650 of the second; execute's own span is no staging
    assert EXPOSED.read(ctx(device, spans)) == pytest.approx((110 + 150) / 1e6 / 2)


def test_dispatch_sums_prepare_and_finish_per_call_in_the_window():
    spans = [
        call([["prepare", -300, -200], ["execute", -200, -50], ["finish", -50, -10]]),  # before the window
        call([["prepare", 10, 30], ["execute", 30, 400], ["finish", 400, 410]]),
        call([["prepare", 500, 540], ["execute", 540, 900], ["finish", 900, 930]]),
        chunk(CHUNK),
    ]
    assert DISPATCH.read(ctx([], spans)) == pytest.approx(((20 + 10) + (40 + 30)) / 1e6 / 2)


@pytest.mark.parametrize("which", ["exposed", "dispatch"])
def test_readers_find_nothing_without_stages(which):
    reader = EXPOSED if which == "exposed" else DISPATCH
    bare = [tr.SpanRecord("score_matrix", "main", 0, 900, {"strategy": "dense"}),
            tr.SpanRecord("pipeline.chunk", "main", 100, 400, {"index": 0, "rows": 7})]
    assert reader.read(ctx([kernel(50, 150)], bare)) is None
    assert reader.read(ctx([kernel(50, 150)], [])) is None


def test_exposed_staging_needs_a_device_trace():
    assert EXPOSED.read(ctx([], [chunk(CHUNK)])) is None


def test_readers_name_their_layer_as_the_benchmark_does():
    layers = {m["name"]: m["layer"] for m in spec.benchmark()["per_layer"]}
    assert layers["staging_exposed_ms.bulk"] == EXPOSED.LAYER == "streaming executor"
    assert layers["dispatch_host_ms.bulk"] == DISPATCH.LAYER == "dispatch"
