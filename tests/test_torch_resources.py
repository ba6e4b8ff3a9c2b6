"""The port's resource accounting (``isoforest_tpu_torch/telemetry/resources.py``)
against the JAX package's, on the CPU.

The bundle's sections and schema, the metric names, labels and help strings
are the JAX package's. What counts as a compile differs: the port counts an
``nvcc`` build of a kernel source and the first build of a model's kernel
tables, through the same counters, log and phase model. The plane bytes are
the JAX package's ``fleet.registry.layout_nbytes`` for the same model, and
the streaming executor notes its two staging buffers.
"""

from __future__ import annotations

import json
import pathlib
import stat
import sys

import numpy as np
import pytest
import torch

from isoforest_tpu.fleet.registry import layout_nbytes as jax_layout_nbytes
from isoforest_tpu.models import ExtendedIsolationForestModel as JaxExtModel
from isoforest_tpu.models import IsolationForestModel as JaxModel
from isoforest_tpu.telemetry import metrics as jax_metrics
from isoforest_tpu.telemetry import resources as jax_resources
from isoforest_tpu_torch import load_model, telemetry
from isoforest_tpu_torch.ops import _build
from isoforest_tpu_torch.ops.streaming import StreamingExecutor
from isoforest_tpu_torch.telemetry import metrics, resources
from isoforest_tpu_torch.utils import monitoring

RESOURCES = pathlib.Path(__file__).parent / "resources" / "torch_port"
FIXTURES = {"standard": (RESOURCES / "mammography_std" / "model", JaxModel),
            "extended": (RESOURCES / "mammography_eif" / "model", JaxExtModel)}
RESOURCE_METRICS = ("isoforest_compile_seconds", "isoforest_compiles_total", "isoforest_host_staging_bytes",
                    "isoforest_resident_plane_bytes")


@pytest.fixture(autouse=True)
def _clean_plane():
    """Each test starts from an empty, enabled plane in the warmup phase,
    and leaves one behind."""
    telemetry.enable()
    telemetry.enable_resources()
    telemetry.reset()
    telemetry.reset_resources()
    yield
    telemetry.enable()
    telemetry.enable_resources()
    telemetry.reset()
    telemetry.reset_resources()


def _fire(duration: float = 0.01, key=None, event=monitoring.TABLE_BUILD_EVENT) -> None:
    """Report one synthetic build, as ``scoring_tables`` and ``_build`` do."""
    monitoring.record_event_duration_secs(event, duration, key=key)


def test_the_schema_is_the_jax_packages():
    assert resources.BUNDLE_SECTIONS == jax_resources.BUNDLE_SECTIONS
    assert resources.BUNDLE_SCHEMA == jax_resources.BUNDLE_SCHEMA
    assert resources.PHASES == jax_resources.PHASES and resources.PLACEMENTS == jax_resources.PLACEMENTS
    assert resources.COMPILE_LOG_MAX == jax_resources.COMPILE_LOG_MAX
    assert resources.ENV_VAR == jax_resources.ENV_VAR
    ours, theirs = metrics.registry().snapshot(), jax_metrics.registry().snapshot()
    for name in RESOURCE_METRICS:
        for field in ("type", "help", "labelnames"):
            assert ours[name][field] == theirs[name][field], (name, field)
    assert set(resources.__all__) == set(jax_resources.__all__)


def test_the_port_installs_its_build_listener():
    assert resources.install_compile_listener() is True
    assert resources._on_event_duration in monitoring._LISTENERS


@pytest.mark.parametrize("event", [monitoring.TABLE_BUILD_EVENT, monitoring.NVCC_BUILD_EVENT])
def test_outermost_scope_wins_and_keys_join(event):
    with resources.compile_scope("serving.prewarm", key="1024"):
        with resources.compile_scope("score_matrix", key="rows=1024"):
            _fire(0.25, key="tables:walk", event=event)
    (entry,) = telemetry.compile_log()
    assert entry["site"] == "serving.prewarm"
    assert entry["key"] == "1024/rows=1024/tables:walk"
    assert entry["phase"] == "warmup"
    assert entry["seconds"] == pytest.approx(0.25)
    assert telemetry.compile_counts() == {"total": 1, "by_site": {"serving.prewarm": 1},
                                          "by_phase": {"steady": 0, "warmup": 1}}
    assert telemetry.compile_seconds_total() == pytest.approx(0.25)


def test_no_open_scope_is_unattributed_and_other_events_are_ignored():
    _fire()
    _fire(event="/jax/core/compile/backend_compile_duration")
    (entry,) = telemetry.compile_log()
    assert entry["site"] == "unattributed" and entry["key"] is None
    assert telemetry.compile_counts()["by_site"] == {"unattributed": 1}


def test_disabled_plane_records_nothing():
    telemetry.disable_resources()
    with resources.compile_scope("score_matrix"):
        _fire()
    telemetry.note_host_staging("score_matrix", 4096)
    assert telemetry.compile_log() == [] and telemetry.compile_counts()["total"] == 0
    assert telemetry.peak_host_staging_bytes() == 0


def test_build_inside_a_request_span_records_its_trace_id():
    with telemetry.span("serving.request") as sp:
        with resources.compile_scope("score_matrix"):
            _fire()
    assert telemetry.compile_log()[0]["trace_id"] == sp.trace_id


def test_compile_log_is_bounded():
    for _ in range(resources.COMPILE_LOG_MAX + 10):
        _fire()
    assert len(telemetry.compile_log()) == resources.COMPILE_LOG_MAX
    assert telemetry.compile_counts()["total"] == resources.COMPILE_LOG_MAX + 10


def test_mark_steady_flips_the_phase_and_records_the_anomaly():
    assert resources.current_phase() == "warmup"
    telemetry.mark_steady()
    with resources.compile_scope("score_matrix", key="rows=3"):
        _fire(key="tables:dense")
    with telemetry.warmup_scope():
        _fire()  # an expected one-time build: shielded
    assert telemetry.compile_counts()["by_phase"] == {"steady": 1, "warmup": 1}
    (event,) = telemetry.get_events(kind="compile.steady_recompile")
    assert event.fields == {"site": "score_matrix", "key": "rows=3/tables:dense", "seconds": 0.01}
    telemetry.mark_warmup()
    assert resources.current_phase() == "warmup"


def test_a_table_build_counts_under_warmup_then_as_steady():
    """A real model's first score builds its walk tables (one compile under
    warmup); after ``mark_steady`` a strategy whose tables are not built yet
    is a steady compile, and scoring again on built tables is none."""
    model = load_model(str(FIXTURES["standard"][0]), device="cpu")
    X = np.random.default_rng(0).normal(size=(5, 6)).astype(np.float32)
    model.score(X, strategy="walk")
    model.score(X, strategy="walk")
    (entry,) = telemetry.compile_log()
    assert (entry["site"], entry["key"], entry["phase"]) == ("score_matrix", "rows=5/tables:walk", "warmup")
    telemetry.mark_steady()
    model.score(X, strategy="walk")
    assert telemetry.compile_counts()["by_phase"]["steady"] == 0
    model.score(X, strategy="dense")
    assert telemetry.compile_counts() == {"total": 2, "by_site": {"score_matrix": 2},
                                          "by_phase": {"steady": 1, "warmup": 1}}
    assert [e.fields["key"] for e in telemetry.get_events(kind="compile.steady_recompile")] == [
        "rows=5/tables:dense"]


def test_an_nvcc_build_counts_as_a_compile(tmp_path, monkeypatch):
    """``_build.build`` reports each kernel source it compiles (here through
    a stand-in compiler that writes the library file)."""
    fake = tmp_path / "nvcc"
    fake.write_text(f"#!{sys.executable}\nimport sys\nopen(sys.argv[sys.argv.index('-o') + 1], 'wb').close()\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(fake))
    with resources.compile_scope("serving.prewarm", key="1024"):
        report = _build.build(["dense", "path_walk"])
    assert sorted(report) == ["dense", "path_walk"]
    assert _build.library_path("dense").exists()
    log = telemetry.compile_log()
    assert sorted(e["key"] for e in log) == ["1024/nvcc:dense", "1024/nvcc:path_walk"]
    assert {e["site"] for e in log} == {"serving.prewarm"}
    assert _build.build(["dense"]) == {}  # built already: nothing more to count
    assert telemetry.compile_counts()["total"] == 2


def test_the_executor_notes_its_two_staging_buffers():
    X = torch.from_numpy(np.random.default_rng(1).normal(size=(30, 6)).astype(np.float32))
    out = StreamingExecutor(lambda c: c.sum(dim=1), 7, device="cpu", site="score_matrix").execute(X)
    assert out.shape == (30,)
    assert telemetry.peak_host_staging_bytes("score_matrix") == 2 * 7 * 6 * 4
    assert telemetry.memory_watermarks()["host_staging"]["score_matrix"] == {
        "current_bytes": 2 * 7 * 6 * 4, "peak_bytes": 2 * 7 * 6 * 4}


def test_host_staging_watermark_keeps_its_peak():
    telemetry.note_host_staging("score_matrix", 4096)
    telemetry.note_host_staging("score_matrix", 1024)
    telemetry.note_host_staging("sharded", 2048)
    assert telemetry.peak_host_staging_bytes("score_matrix") == 4096
    assert telemetry.peak_host_staging_bytes() == 4096
    assert telemetry.memory_watermarks()["host_staging"]["score_matrix"] == {"current_bytes": 1024,
                                                                               "peak_bytes": 4096}


def test_plane_placement_by_backend():
    assert resources.plane_placement("tpu") == "device"
    assert resources.plane_placement("gpu") == "device"
    assert resources.plane_placement("cpu") == "host"
    assert resources.plane_placement() == "host"  # this host has no card


@pytest.mark.parametrize("q16", [False, True], ids=["f32", "q16"])
@pytest.mark.parametrize("kind", sorted(FIXTURES))
def test_layout_bytes_equal_the_jax_packages(kind, q16):
    path, jax_cls = FIXTURES[kind]
    ours, theirs = load_model(str(path), device="cpu"), jax_cls.load(str(path))
    if q16:
        ours.set_scoring_representation("q16")
        theirs.set_scoring_representation("q16")
    want = jax_layout_nbytes(theirs)
    assert resources._layout_nbytes(ours) == want
    assert telemetry.model_plane_bytes(ours) == {"host": want, "device": 0, "plane": "q16" if q16 else "f32",
                                                 "placement": "host"}
    on_card = telemetry.model_plane_bytes(ours, platform="gpu")
    assert on_card["device"] == want and on_card["placement"] == "device"


def test_account_and_release_roll_up():
    resources.account_resident_plane("a", 1000, 0, plane="f32")
    resources.account_resident_plane("b", 500, 500, plane="q16")
    totals = telemetry.resident_plane_bytes()
    assert totals["host"] == 1500 and totals["device"] == 500 and totals["models"]["b"]["plane"] == "q16"
    series = telemetry.snapshot()["metrics"]["isoforest_resident_plane_bytes"]["series"]
    assert {s["labels"]["placement"]: s["value"] for s in series} == {"host": 1500.0, "device": 500.0}
    resources.release_resident_plane("a")
    assert list(telemetry.resident_plane_bytes()["models"]) == ["b"]


def test_config_fingerprint_names_torch_where_the_jax_package_names_jax():
    ours, theirs = resources.config_fingerprint(), jax_resources.config_fingerprint()
    assert set(ours) == (set(theirs) - {"jax"}) | {"torch", "cuda"}
    assert ours["backend"] == "cpu" and theirs["backend"] == "cpu"
    assert ours["package_version"] == theirs["package_version"]
    assert all(k.startswith("ISOFOREST_TPU_") for k in ours["env"]) and ours["env"] == theirs["env"]


def test_bundle_has_exactly_the_jax_packages_sections():
    with telemetry.span("score_matrix"):
        pass
    with resources.compile_scope("score_matrix", key="rows=1024"):
        _fire()
    telemetry.note_host_staging("score_matrix", 8192)
    resources.account_resident_plane("tenant-a", 4096, 0)
    bundle = telemetry.build_bundle()
    theirs = jax_resources.build_bundle()
    assert sorted(bundle) == sorted(resources.BUNDLE_SECTIONS) == sorted(theirs)
    for section in ("degradations", "autotune", "compiles", "memory"):
        assert sorted(bundle[section]) == sorted(theirs[section]), section
    assert bundle["schema"] == telemetry.BUNDLE_SCHEMA
    assert bundle["compiles"]["total"] == 1 and bundle["compile_log"][0]["site"] == "score_matrix"
    assert bundle["memory"]["host_staging_peak_bytes"] == 8192
    assert bundle["memory"]["resident_plane_bytes"]["host"] == 4096
    assert "isoforest_compiles_total" in bundle["metrics"]


def test_empty_process_still_yields_a_wellformed_bundle():
    bundle = telemetry.build_bundle()
    assert sorted(bundle) == sorted(resources.BUNDLE_SECTIONS)
    assert bundle["compiles"] == {"total": 0, "by_site": {}, "by_phase": {"steady": 0, "warmup": 0}}
    assert bundle["memory"]["resident_plane_bytes"]["models"] == {}


def test_write_bundle_round_trips_json_and_tails_are_bounded(tmp_path):
    for i in range(12):
        with telemetry.span("score_matrix", i=i):
            pass
        telemetry.record_event("demo.event", i=i)
    doc = telemetry.write_bundle(str(tmp_path / "bundle.json"), trace_limit=3, event_tail=5)
    assert json.loads((tmp_path / "bundle.json").read_text()) == json.loads(json.dumps(doc))
    assert len(doc["traces"]) <= 3 and len(doc["events"]) == 5


def test_a_broken_provider_does_not_break_the_bundle():
    resources.register_bundle_section("broken", lambda: 1 / 0)
    try:
        assert "ZeroDivisionError" in telemetry.build_bundle()["broken"]["error"]
    finally:
        resources.unregister_bundle_section("broken")
    assert "broken" not in telemetry.build_bundle()
