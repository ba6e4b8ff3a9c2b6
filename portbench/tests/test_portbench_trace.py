"""The traced run's arithmetic on hand-made intervals: busy and idle time,
the kernels launched inside a span, and what the host was doing in a gap."""

import pytest

from portbench import trace as tr


def interval(name, kind, start, end, corr=0):
    return tr.Interval(name, kind, start, end, corr)


def span(name, start, end):
    return tr.SpanRecord(name, "main", start, end, {})


def ctx():
    device = [
        interval("k1", "kernel", 10, 30, corr=1),
        interval("k2", "kernel", 25, 40, corr=2),  # overlaps k1
        interval("Memcpy HtoD", "gpu_memcpy", 60, 70),
        interval("k3", "kernel", 80, 120, corr=3),  # runs past the window
    ]
    spans = [span("model.score", 0, 50), span("score_matrix", 5, 45), span("score_matrix", 75, 78)]
    return {"device": device, "launches": {1: 6, 2: 20, 3: 76}, "spans": spans, "w0_ns": 0, "w1_ns": 100}


def test_busy_and_idle():
    c = ctx()
    assert tr.busy_ns(c["device"], 0, 100) == 30 + 10 + 20
    assert tr.idle_gaps(c["device"], 0, 100) == [(0, 10), (40, 60), (70, 80)]
    assert tr.idle_share(c) == pytest.approx(40.0)


def test_kernels_launched_inside_a_span():
    c = ctx()
    # k1 and k2 launched inside the first score_matrix span, k3 inside the
    # second; k3 is clipped to the window
    assert tr.kernel_ns_in_spans(c, "score_matrix") == 20 + 15 + 20
    c["launches"] = {1: 2, 2: 20, 3: 90}  # k1 launched before the span, k3 after it
    assert tr.kernel_ns_in_spans(c, "score_matrix") == 15
    c["launches"] = {}
    assert tr.kernel_ns_in_spans(c, "score_matrix") is None


def test_host_activity_at_each_gap():
    c = ctx()
    assert tr.host_activities(c["spans"], [5, 47, 50, 60, 76]) == [
        "model.score>score_matrix", "model.score", "outside the program", "outside the program", "score_matrix"]
    assert tr.top_idle_gaps(c) == [["outside the program", 2e-08], ["model.score>score_matrix", 1e-08],
                                   ["score_matrix", 1e-08]]


def test_roofline_share_of_the_window_work():
    c = ctx()
    c.update(rows_scored=10, ops=67e12 * 55e-9 / 2, bytes=0.0, peaks={"f32_ops_per_s": 67e12, "bytes_per_s": 3.35e12})
    assert tr.roofline_share(c) == pytest.approx(50.0)
    c["peaks"] = None
    assert tr.roofline_share(c) is None

