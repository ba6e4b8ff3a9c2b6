"""The port's logging and phase tracing (``isoforest_tpu_torch/utils/logging.py``)
against the JAX package's (``isoforest_tpu/utils/logging.py``), on the CPU:
the same levels from the same environment, the same phase records, one
handler across reloads, and a ``torch.profiler`` trace file where the JAX
package writes a ``jax.profiler`` trace."""

from __future__ import annotations

import importlib
import json
import logging

import pytest
import torch

from isoforest_tpu import telemetry as jtelemetry
from isoforest_tpu.utils import logging as jlog
from isoforest_tpu_torch import telemetry
from isoforest_tpu_torch.utils import logging as tlog


@pytest.fixture
def restore_levels():
    saved = (tlog.logger.level, jlog.logger.level)
    yield
    tlog.logger.setLevel(saved[0])
    jlog.logger.setLevel(saved[1])


@pytest.mark.parametrize("env", ["DEBUG", "error", "WARNING", None])
def test_set_level_reads_the_environment_as_the_jax_package(monkeypatch, restore_levels, env):
    if env is None:
        monkeypatch.delenv(tlog.LOGLEVEL_ENV, raising=False)
    else:
        monkeypatch.setenv(tlog.LOGLEVEL_ENV, env)
    assert tlog.LOGLEVEL_ENV == jlog.LOGLEVEL_ENV
    assert tlog.set_level() == jlog.set_level()
    assert tlog.set_level("INFO") == jlog.set_level("INFO") == "INFO"
    assert tlog.set_level(logging.ERROR) == jlog.set_level(logging.ERROR) == "ERROR"
    assert tlog.logger.name == "isoforest_tpu_torch"


def test_reload_does_not_duplicate_the_handler():
    def marked():
        return [h for h in tlog.logger.handlers if getattr(h, tlog._HANDLER_MARK, False)]

    assert len(marked()) == 1
    importlib.reload(tlog)
    assert len(marked()) == 1


def _phase_messages(caplog, log, name):
    with caplog.at_level(logging.INFO, logger=log.logger.name):
        with log.phase(name):
            pass
    return [r for r in caplog.records if r.name == log.logger.name and name in r.getMessage()]


@pytest.mark.parametrize("telemetry_on", [True, False], ids=["span", "annotation"])
def test_phase_logs_and_records_as_the_jax_package(caplog, restore_levels, telemetry_on):
    was_on = telemetry.enabled(), jtelemetry.enabled()
    for t in (telemetry, jtelemetry):
        t.enable() if telemetry_on else t.disable()
    try:
        before = len(telemetry.span_records("test.phase")), len(jtelemetry.span_records("test.phase"))
        ours = _phase_messages(caplog, tlog, "test.phase")
        caplog.clear()
        theirs = _phase_messages(caplog, jlog, "test.phase")
        after = len(telemetry.span_records("test.phase")), len(jtelemetry.span_records("test.phase"))
    finally:
        for t, on in zip((telemetry, jtelemetry), was_on):
            t.enable() if on else t.disable()
    assert len(ours) == len(theirs) == 1 and ours[0].levelno == theirs[0].levelno == logging.INFO
    strip = lambda r: r.getMessage().rsplit(" ", 1)[0]  # noqa: E731 -- drop the time
    assert strip(ours[0]) == strip(theirs[0]) == "phase test.phase took"
    assert after[0] - before[0] == after[1] - before[1] == int(telemetry_on)


def test_trace_writes_a_profiler_trace_on_the_cpu(tmp_path):
    with tlog.trace(str(tmp_path)):
        with tlog.phase("test.traced_phase"):
            torch.ones(64).sum()
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "test.traced_phase" for e in events)
