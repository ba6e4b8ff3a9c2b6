"""The port's command line (``python -m isoforest_tpu_torch``) on the CPU:
the ``serve``, ``route`` and ``journal`` subcommands, as the JAX package's
CLI cases drive them (``tests/test_fleet.py``, ``tests/test_serving.py``,
``tests/test_federation.py``).

* ``serve`` in both modes (one model, ``--models-dir``) comes up, prints
  its ready line and exits 0 with ``--max-seconds 0``; both modes at once
  is a usage error (2); with no ``--device`` and no card it raises before
  it serves, never falling back to the CPU.
* ``journal`` dumps a spool as JSON lines or one Chrome trace; an unknown
  spool is a usage error.
* ``route --replicas 1 --device cpu --max-seconds 0`` spawns a real
  ``serve`` child from a directory outside the repository, drains it and
  exits 0, under the test's own timeout.

No real sleeps: every wait budget is zero, and the spawned process has its
own timeout.
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

from isoforest_tpu_torch import telemetry
from isoforest_tpu_torch.__main__ import main
from isoforest_tpu_torch.telemetry import TraceContext
from isoforest_tpu_torch.telemetry.journal import activate_journal, deactivate_journal, read_spool

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "resources" / "torch_port"
ROUTE_TIMEOUT_S = 180


@pytest.fixture(autouse=True)
def _clean():
    telemetry.reset()
    deactivate_journal()
    telemetry.set_trace_policy(slow_threshold_s=0.0, sample_every=1)
    yield
    deactivate_journal()
    telemetry.reset()
    telemetry.set_trace_policy(slow_threshold_s=0.25, sample_every=1)


@pytest.fixture()
def models_dir(tmp_path):
    root = tmp_path / "models"
    for kind in ("mammography_std", "mammography_eif"):
        shutil.copytree(FIXTURES / kind / "model", root / kind)
    return root


def _ready(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


class TestServe:
    def test_one_model_smoke(self, tmp_path, capsys):
        """``serve <model_dir> --max-seconds 0``: comes up with its manager
        (the fixture has a baseline), prints the ready line, exits 0."""
        model_dir = tmp_path / "m"
        shutil.copytree(FIXTURES / "mammography_std" / "model", model_dir)
        rc = main(["serve", str(model_dir), "--port", "0", "--max-seconds", "0", "--work-dir",
                   str(tmp_path / "wd"), "--device", "cpu"])
        assert rc == 0
        ready = _ready(capsys)
        assert ready["serving"] is True and ready["lifecycle"] is True and ready["generation"] == 1
        assert ready["endpoint"].endswith("/score") and ready["device"] == "cpu"

    def test_fleet_smoke(self, models_dir, tmp_path, capsys):
        """``serve --models-dir --max-seconds 0``: a fleet ready line naming
        the tenants."""
        rc = main(["serve", "--models-dir", str(models_dir), "--port", "0", "--max-seconds", "0",
                   "--fleet-budget-mb", "64", "--work-dir", str(tmp_path / "work"), "--device", "cpu"])
        assert rc == 0
        ready = _ready(capsys)
        assert ready["fleet"] is True
        assert ready["models"] == ["mammography_eif", "mammography_std"]
        assert ready["endpoint"].endswith("/score/<model_id>")
        assert ready["budget_bytes"] == 64 << 20
        assert len(telemetry.get_events(kind="fleet.start")) == 1

    def test_refuses_both_modes(self, models_dir, tmp_path, capsys):
        rc = main(["serve", str(models_dir / "mammography_std"), "--models-dir", str(models_dir),
                   "--max-seconds", "0", "--device", "cpu"])
        assert rc == 2
        assert "exactly one" in capsys.readouterr().err

    @pytest.mark.parametrize("mode", ["model", "fleet"])
    def test_no_card_with_the_default_device_raises(self, models_dir, tmp_path, capsys, monkeypatch, mode):
        import torch

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        target = [str(models_dir / "mammography_std")] if mode == "model" else ["--models-dir", str(models_dir)]
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["serve", *target, "--max-seconds", "0", "--work-dir", str(tmp_path / "wd")])
        assert capsys.readouterr().out == ""

    def test_replica_flags_beat_and_journal(self, models_dir, tmp_path, capsys):
        """``--replica-name`` with ``--heartbeat-dir`` writes the heartbeat
        the router reads; ``--journal-dir`` spools under the replica's name
        from before the fleet starts to a clean stop."""
        hb, journal = tmp_path / "hb", tmp_path / "journal"
        rc = main(["serve", "--models-dir", str(models_dir), "--max-seconds", "0", "--device", "cpu",
                   "--work-dir", str(tmp_path / "work"), "--replica-name", "replica-7", "--heartbeat-dir", str(hb),
                   "--journal-dir", str(journal)])
        assert rc == 0
        assert _ready(capsys)["replica"] == "replica-7"
        assert (hb / "heartbeat-replica-7.json").is_file()
        kinds = [r["kind"] for r in read_spool(str(journal / "replica-7"))["records"] if r["type"] == "event"]
        assert kinds[0] == "journal.start" and kinds[-1] == "journal.stop" and "fleet.start" in kinds


# --------------------------------------------------------------------------- #
# the journal CLI (python -m isoforest_tpu_torch journal <dir>)
# --------------------------------------------------------------------------- #


class TestJournalCLI:
    @pytest.fixture()
    def spooled(self, tmp_path):
        activate_journal(str(tmp_path), "cli-spool")
        telemetry.record_event("fleet.load", model_id="alpha", generation=1)
        with telemetry.with_context(TraceContext("cli-1")):
            with telemetry.span("serving.request"):
                pass
        deactivate_journal()
        return str(tmp_path)

    def test_json_dump_tags_records_with_spool(self, spooled, capsys):
        from isoforest_tpu_torch.__main__ import main

        rc = main(["journal", spooled])
        captured = capsys.readouterr()
        assert rc == 0
        records = [json.loads(line) for line in captured.out.splitlines()]
        assert all(r["spool"] == "cli-spool" for r in records)
        kinds = [r.get("kind") for r in records if r.get("type") == "event"]
        assert kinds[0] == "journal.start" and kinds[-1] == "journal.stop"
        assert any(r.get("type") == "trace" for r in records)
        summary = json.loads(captured.err.strip().splitlines()[-1])
        assert summary["spools"]["cli-spool"]["torn_tail"] is False

    def test_chrome_dump_renders_one_lane_per_spool(self, spooled, tmp_path):
        from isoforest_tpu_torch.__main__ import main

        out = str(tmp_path / "merged.json")
        rc = main(["journal", spooled, "--format", "chrome", "--output", out])
        assert rc == 0
        with open(out) as fh:
            doc = json.load(fh)
        lanes = [
            e["args"]["name"] for e in doc["traceEvents"]
            if e["ph"] == "M" and e["name"] == "process_name"
        ]
        assert lanes == ["cli-spool"]
        assert any(
            e["ph"] == "X" and e["name"] == "serving.request"
            for e in doc["traceEvents"]
        )

    def test_unknown_spool_is_a_usage_error(self, spooled, capsys):
        from isoforest_tpu_torch.__main__ import main

        rc = main(["journal", spooled, "--spool", "nope"])
        assert rc == 2
        assert "no spool" in capsys.readouterr().err


    def test_no_spools_is_a_usage_error(self, tmp_path, capsys):
        rc = main(["journal", str(tmp_path)])
        assert rc == 2
        assert "no journal spools" in capsys.readouterr().err

    def test_tail_keeps_the_newest_records(self, spooled, capsys):
        rc = main(["journal", spooled, "--tail", "2"])
        assert rc == 0
        records = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
        assert len(records) == 2 and records[-1]["kind"] == "journal.stop"


# --------------------------------------------------------------------------- #
# route: a real spawned replica
# --------------------------------------------------------------------------- #

# the router runs from a directory outside the repository, with no
# PYTHONPATH: only the package's own path to its spawned replica lets the
# child import it
ROUTE_BOOT = (
    "import sys; sys.path.insert(0, sys.argv[1]); "
    "from isoforest_tpu_torch.__main__ import main; sys.exit(main(sys.argv[2:]))"
)


def test_route_spawns_a_replica_and_drains_it(models_dir, tmp_path):
    journal = tmp_path / "journal"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    away = tmp_path / "elsewhere"
    away.mkdir()
    proc = subprocess.run(
        [sys.executable, "-c", ROUTE_BOOT, str(ROOT), "route", "--models-dir", str(models_dir), "--replicas", "1",
         "--device", "cpu", "--max-seconds", "0", "--journal-dir", str(journal), "--work-dir", str(tmp_path / "work"),
         "--probe-interval-s", "0.2"],
        cwd=away, env=env, capture_output=True, text=True, timeout=ROUTE_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ready = json.loads(proc.stdout.strip().splitlines()[-1])
    assert ready["router"] is True and ready["endpoint"].endswith("/score/<model_id>")
    [replica] = ready["replicas"]
    assert replica["name"] == "replica-0" and replica["url"].startswith("http://127.0.0.1:")
    # the replica was drained (SIGTERM, then reaped): gone, its spool closed
    with pytest.raises(ProcessLookupError):
        os.kill(replica["pid"], 0)
    assert sorted(os.listdir(journal)) == ["replica-0", "router"]
    replica_kinds = [r["kind"] for r in read_spool(str(journal / "replica-0"))["records"] if r["type"] == "event"]
    assert replica_kinds[0] == "journal.start" and replica_kinds[-1] == "journal.stop"
    assert "fleet.start" in replica_kinds
    router_kinds = [r["kind"] for r in read_spool(str(journal / "router"))["records"] if r["type"] == "event"]
    for kind in ("router.replica_up", "router.start", "router.replica_drain", "router.stop"):
        assert kind in router_kinds, router_kinds
    # heartbeats land beside the models, where the router's /healthz reads them
    assert (models_dir / ".router-heartbeats" / "heartbeat-replica-0.json").is_file()
