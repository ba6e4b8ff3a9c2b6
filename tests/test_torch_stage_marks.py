"""Stage marks inside the port's spans (``telemetry/spans.py``, ``mark``) on
the CPU: the executor's ``wait``/``pack``/``copy``/``launch`` in each
``pipeline.chunk`` span, ``score_matrix``'s ``prepare``/``execute``/``finish``,
the per-execution ``isoforest_pipeline_stage_seconds`` counts, and nothing at
all while telemetry is off."""

from __future__ import annotations

import pathlib
import time

import numpy as np
import pytest
import torch

from isoforest_tpu_torch import load_model, telemetry
from isoforest_tpu_torch.ops import streaming
from isoforest_tpu_torch.telemetry import spans

FIXTURE = pathlib.Path(__file__).parent / "resources" / "torch_port" / "mammography_std" / "model"
STAGED = ["wait", "pack", "copy", "launch"]


@pytest.fixture
def fresh():
    telemetry.enable()
    telemetry.reset()
    yield
    telemetry.enable()


def _executor(seen, **kw):
    """An executor whose chunk records a ``time.time_ns()`` taken inside its
    ``launch`` stage."""

    def run_chunk(xc):
        seen.append(time.time_ns())
        return xc.sum(dim=1)

    return streaming.StreamingExecutor(run_chunk, 7, device="cpu", site="stage_test", **kw)


def _rows(n=20, f=3):
    return torch.arange(n * f, dtype=torch.float32).reshape(n, f)


def _check_contiguous(stages):
    assert all(isinstance(x, int) for _, s, e in stages for x in (s, e))
    assert all(s <= e for _, s, e in stages)
    assert all(a[2] == b[1] for a, b in zip(stages, stages[1:]))


def test_staged_chunks_carry_wait_pack_copy_launch_in_order_inside_the_span(fresh):
    seen = []
    before = time.time_ns()
    out = _executor(seen).execute(_rows())
    after = time.time_ns()
    torch.testing.assert_close(out, _rows().sum(dim=1), rtol=0, atol=0)
    chunks = [r for r in spans.records("pipeline.chunk") if r.attrs["site"] == "stage_test"]
    assert [r.attrs["index"] for r in chunks] == [0, 1, 2]
    for record, inside in zip(chunks, seen):
        stages = record.attrs["stages"]
        assert [name for name, _, _ in stages] == STAGED
        _check_contiguous(stages)
        # the span's start is the same time_ns reading, kept as float seconds
        assert stages[0][1] >= record.start_unix_s * 1e9 - 1e3
        assert before <= stages[0][1] and stages[-1][2] <= after
        launch = stages[-1]
        assert launch[1] <= inside <= launch[2]
        assert not {"h2d_s", "compute_dispatch_s"} & set(record.attrs)
    assert [c.attrs["stages"][-1][2] <= n.attrs["stages"][0][1] for c, n in zip(chunks, chunks[1:])] == [True] * 2


def test_unstaged_chunks_carry_copy_and_launch(fresh):
    """Without staging (rows on the card, or ``pipeline=False``) a chunk is
    a view or a synchronous copy: ``copy``, then ``launch``."""
    seen = []
    _executor(seen, streaming=False).execute(_rows())
    chunks = [r for r in spans.records("pipeline.chunk") if r.attrs["site"] == "stage_test"]
    assert len(chunks) == 3
    for record, inside in zip(chunks, seen):
        stages = record.attrs["stages"]
        assert [name for name, _, _ in stages] == ["copy", "launch"]
        _check_contiguous(stages)
        assert stages[1][1] <= inside <= stages[1][2]
    assert streaming._PIPELINE_STAGE.summary(site="stage_test", stage="wait")["count"] == 0
    assert streaming._PIPELINE_STAGE.summary(site="stage_test", stage="copy")["count"] == 1


def test_stage_seconds_sum_the_marks_once_per_execution(fresh):
    for _ in range(2):
        _executor([]).execute(_rows())
    chunks = [r for r in spans.records("pipeline.chunk") if r.attrs["site"] == "stage_test"]
    assert len(chunks) == 6
    execs = [chunks[:3], chunks[3:]]
    per_exec = [{name: sum(e - s for r in ex for n, s, e in r.attrs["stages"] if n == name) for name in STAGED}
                for ex in execs]
    for name in STAGED:
        summary = streaming._PIPELINE_STAGE.summary(site="stage_test", stage=name)
        assert summary["count"] == 2
        assert summary["sum"] == pytest.approx(sum(p[name] for p in per_exec) / 1e9, rel=1e-12, abs=0)
        assert {summary["min"], summary["max"]} <= {p[name] / 1e9 for p in per_exec}
    h2d = streaming._PIPELINE_H2D.summary(site="stage_test")
    assert h2d["count"] == 2
    assert {h2d["min"], h2d["max"]} <= {(p["wait"] + p["pack"] + p["copy"]) / 1e9 for p in per_exec}
    runs = [e for e in telemetry.get_events("pipeline.run") if e.fields["site"] == "stage_test"]
    assert [e.fields["h2d_s"] for e in runs] == [round((p["wait"] + p["pack"] + p["copy"]) / 1e9, 6)
                                                for p in per_exec]


def test_score_matrix_marks_prepare_execute_finish_around_its_chunks(fresh):
    X = np.random.default_rng(0).normal(size=(1500, 6)).astype(np.float32)
    model = load_model(str(FIXTURE), device="cpu")
    spans.reset_spans()
    model.score(X, strategy="walk", chunk_size=512)
    (call,) = spans.records("score_matrix")
    stages = call.attrs["stages"]
    assert [name for name, _, _ in stages] == ["prepare", "execute", "finish"]
    _check_contiguous(stages)
    execute = stages[1]
    chunks = spans.records("pipeline.chunk")
    assert len(chunks) == 3
    for record in chunks:
        assert [name for name, _, _ in record.attrs["stages"]] == STAGED
        assert execute[1] <= record.attrs["stages"][0][1] and record.attrs["stages"][-1][2] <= execute[2]
    (outer,) = spans.records("model.score")
    assert "stages" not in outer.attrs  # only what is marked carries stages


def test_disabled_telemetry_records_no_mark():
    telemetry.enable()
    telemetry.reset()
    telemetry.disable()
    try:
        sp = spans.span("pipeline.chunk", index=0)
        assert sp is spans._NULL_SPAN
        with sp as entered:
            entered.mark("pack")
        assert entered.stages == ()
        _executor([]).execute(_rows())
    finally:
        telemetry.enable()
    assert spans.records() == []
    assert streaming._PIPELINE_STAGE.snapshot()["series"] == []
    assert streaming._PIPELINE_H2D.snapshot()["series"] == []


def test_an_unmarked_span_has_no_stages(fresh):
    with spans.span("demo.unmarked", rows=3) as sp:
        pass
    assert sp.stages == []
    (record,) = spans.records("demo.unmarked")
    assert record.attrs == {"rows": 3}
