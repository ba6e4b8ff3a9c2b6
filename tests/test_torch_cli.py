"""The port's command line (``python -m isoforest_tpu_torch``) on the CPU:
its fifteen subcommands, as the JAX package's CLI cases drive them
(``tests/test_cli.py``, the ``TestCli`` classes of ``tests/test_monitor.py``,
``tests/test_lifecycle.py`` and ``tests/test_stream.py``,
``tests/test_autotune.py::TestCLI``, the CLI cases of
``tests/test_telemetry.py`` and ``tests/test_out_of_core.py``, and the
``serve``, ``route`` and ``journal`` cases of ``tests/test_fleet.py``,
``tests/test_serving.py`` and ``tests/test_federation.py``), every one with
``--device cpu`` (the kernels' plain versions).

* Across the packages, on the mammography rows where the port's fit grows
  the JAX package's forest node for node: the port's ``fit`` summary is
  the JAX CLI's plus ``device`` (its threshold within 2e-6, as
  ``tests/test_torch_fit.py`` holds it); the port's ``score`` CSV of the
  JAX-written model is the JAX CLI's byte for byte on every row whose
  scores are equal; ``inspect`` prints the JAX CLI's JSON plus ``device``.
* Each subcommand that loads or fits a model, with no ``--device`` and no
  card, raises before it reads its input (the input paths do not exist).
* ``score --strategy`` refuses the JAX package's ``gather`` before it
  writes its output or sink.

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


# --------------------------------------------------------------------------- #
# fit / score / convert / inspect (tests/test_cli.py on the port)
# --------------------------------------------------------------------------- #


def _last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def csv_file(tmp_path_factory):
    import numpy as np

    rng = np.random.default_rng(0)
    X = rng.normal(size=(2000, 4)).astype(np.float32)
    X[:40] += 6.0
    y = np.zeros(2000)
    y[:40] = 1
    path = tmp_path_factory.mktemp("cli") / "data.csv"
    np.savetxt(path, np.column_stack([X, y]), delimiter=",")
    return str(path)


CPU = ["--device", "cpu"]


class TestCli:
    def test_fit_score_convert_inspect(self, csv_file, tmp_path, capsys):
        import numpy as np

        from isoforest_tpu_torch.onnx.runtime import run_model

        model_dir = str(tmp_path / "model")
        rc = main(["fit", "--input", csv_file, "--labeled", "--output", model_dir,
                   "--num-estimators", "20", "--contamination", "0.02", *CPU])
        assert rc == 0
        summary = _last_json(capsys.readouterr().out)
        assert summary["numTrees"] == 20
        assert summary["auroc"] > 0.9
        assert summary["device"] == "cpu"

        scores_csv = str(tmp_path / "scores.csv")
        rc = main(["score", "--model", model_dir, "--input", csv_file, "--labeled", "--output", scores_csv, *CPU])
        assert rc == 0
        out = np.loadtxt(scores_csv, delimiter=",", skiprows=1)
        assert out.shape == (2000, 2)
        assert set(np.unique(out[:, 1])) <= {0.0, 1.0}

        onnx_path = str(tmp_path / "m.onnx")
        rc = main(["convert", "--model", model_dir, "--output", onnx_path])
        assert rc == 0
        s, _ = run_model(open(onnx_path, "rb").read(), {"features": np.zeros((5, 4), np.float32)})
        assert s.shape == (5, 1)

        rc = main(["inspect", "--model", model_dir, *CPU])
        assert rc == 0
        info = _last_json(capsys.readouterr().out)
        assert info["numTrees"] == 20
        assert info["params"]["numEstimators"] == 20
        assert info["device"] == "cpu"

    def test_chunked_score_matches_unchunked(self, csv_file, tmp_path):
        """Each chunk's rows are ``model.score`` of that chunk, bit for bit.
        On the CPU torch's ``exp2`` rounds by vector position, so the
        300-row chunks may differ from one call by an ulp (ROADMAP C, "A CPU
        sink and chunking"); ``chip_smoke.py`` phase 36 holds the card's
        chunked and unchunked CSVs equal."""
        import numpy as np

        from isoforest_tpu_torch import load_model

        model_dir = str(tmp_path / "model")
        assert main(["fit", "--input", csv_file, "--labeled", "--output", model_dir, "--num-estimators", "15",
                     *CPU]) == 0
        out_a = str(tmp_path / "a.csv")
        out_b = str(tmp_path / "b.csv")
        assert main(["score", "--model", model_dir, "--input", csv_file, "--labeled", "--output", out_a, *CPU]) == 0
        assert main(["score", "--model", model_dir, "--input", csv_file, "--labeled", "--output", out_b,
                     "--chunk-rows", "300", *CPU]) == 0
        a = np.loadtxt(out_a, delimiter=",", skiprows=1)
        b = np.loadtxt(out_b, delimiter=",", skiprows=1)
        X = np.loadtxt(csv_file, delimiter=",")[:, :-1].astype(np.float32)
        model = load_model(model_dir, device="cpu")
        np.testing.assert_array_equal(a[:, 0], model.score(X).numpy())
        by_chunk = np.concatenate([model.score(X[i:i + 300]).numpy() for i in range(0, len(X), 300)])
        np.testing.assert_array_equal(b[:, 0], by_chunk)
        np.testing.assert_array_equal(a[:, 1], b[:, 1])
        ulp = np.spacing(np.abs(a[:, 0]).astype(np.float32))
        assert np.all(np.abs(a[:, 0] - b[:, 0]) <= ulp)

    def test_inspect_tree_structure(self, csv_file, tmp_path, capsys):
        model_dir = str(tmp_path / "m2")
        main(["fit", "--input", csv_file, "--labeled", "--output", model_dir, "--num-estimators", "3",
              "--max-samples", "32", *CPU])
        capsys.readouterr()
        rc = main(["inspect", "--model", model_dir, "--tree", "0", *CPU])
        assert rc == 0
        s = capsys.readouterr().out.strip()
        assert s.startswith(("InternalNode(", "ExternalNode("))

    def test_extended_fit(self, csv_file, tmp_path, capsys):
        model_dir = str(tmp_path / "ext")
        rc = main(["fit", "--input", csv_file, "--labeled", "--output", model_dir, "--extended",
                   "--extension-level", "2", "--num-estimators", "10", *CPU])
        assert rc == 0
        rc = main(["inspect", "--model", model_dir, *CPU])
        info = _last_json(capsys.readouterr().out)
        assert info["class"] == "ExtendedIsolationForestModel"
        assert info["params"]["extensionLevel"] == 2

    def test_fit_without_overwrite_fails(self, csv_file, tmp_path):
        model_dir = str(tmp_path / "dup")
        main(["fit", "--input", csv_file, "--output", model_dir, "--num-estimators", "3", "--max-samples", "32",
              *CPU])
        with pytest.raises(FileExistsError):
            main(["fit", "--input", csv_file, "--output", model_dir, "--num-estimators", "3",
                  "--max-samples", "32", *CPU])


class TestNonFiniteWarning:
    def test_warns_on_nan(self, caplog):
        import logging

        import numpy as np

        from isoforest_tpu_torch.utils.validation import extract_features

        X = np.ones((10, 3), np.float32)
        X[0, 0] = np.nan
        with caplog.at_level(logging.WARNING, logger="isoforest_tpu_torch"):
            extract_features(X)
        assert any("non-finite" in r.message for r in caplog.records)


class TestStrategies:
    def test_refused_strategy_writes_nothing(self, csv_file, tmp_path):
        """The JAX package's ``gather`` is refused with the port's message,
        before the output file or the sink directory exists."""
        model_dir = str(FIXTURES / "mammography_std" / "model")
        out = tmp_path / "scores.csv"
        with pytest.raises(ValueError, match="unknown scoring strategy 'gather'"):
            main(["score", "--model", model_dir, "--input", csv_file, "--output", str(out), "--strategy", "gather",
                  *CPU])
        assert not out.exists()
        sink = tmp_path / "sink"
        with pytest.raises(ValueError, match="unknown scoring strategy 'gather'"):
            main(["score", "--model", model_dir, "--source", csv_file, "--output", str(sink), "--strategy",
                  "gather", *CPU])
        assert not sink.exists()

    def test_help_lists_every_subcommand_and_device(self, capsys):
        with pytest.raises(SystemExit):
            main(["--help"])
        text = capsys.readouterr().out
        for name in SUBCOMMANDS_WITH_A_MODEL + ["convert", "serve", "route", "journal"]:
            assert name in text
        for name in SUBCOMMANDS_WITH_A_MODEL:
            with pytest.raises(SystemExit):
                main([name, "--help"])
            assert "--device" in capsys.readouterr().out, name


# --------------------------------------------------------------------------- #
# the JAX CLI's documents, across the packages
# --------------------------------------------------------------------------- #


FIT_ARGS = ["--labeled", "--num-estimators", "24", "--max-samples", "64", "--contamination", "0.05",
            "--random-seed", "5"]


@pytest.fixture(scope="module")
def both_clis(tmp_path_factory, mammography):
    """The JAX CLI and the port's on the first 3,000 mammography rows (the
    rows of ``tests/test_torch_fit.py``'s node-for-node fit): fit, score
    of the JAX-written model, inspect."""
    import contextlib
    import io

    import numpy as np

    from isoforest_tpu.__main__ import main as jax_main

    root = tmp_path_factory.mktemp("both")
    X, y = mammography
    data = str(root / "d.csv")
    np.savetxt(data, np.column_stack([X[:3000], y[:3000]]), delimiter=",")

    def run(fn, argv):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert fn(argv) == 0
        return out.getvalue()

    jax_dir, port_dir = str(root / "jax_model"), str(root / "port_model")
    docs = {
        "fit": (_last_json(run(jax_main, ["fit", "--input", data, "--output", jax_dir, *FIT_ARGS])),
                _last_json(run(main, ["fit", "--input", data, "--output", port_dir, *FIT_ARGS, *CPU]))),
        "inspect": (_last_json(run(jax_main, ["inspect", "--model", jax_dir])),
                    _last_json(run(main, ["inspect", "--model", jax_dir, *CPU]))),
    }
    for fn, name, extra in ((jax_main, "jax", []), (main, "port", CPU)):
        run(fn, ["score", "--model", jax_dir, "--input", data, "--labeled", "--output", str(root / f"{name}.csv"),
                 *extra])
    docs["score"] = tuple((root / f"{name}.csv").read_text().splitlines() for name in ("jax", "port"))
    return docs, jax_dir, port_dir


def test_fit_summary_is_the_jax_clis(both_clis):
    docs, jax_dir, port_dir = both_clis
    jax_doc, port_doc = docs["fit"]
    assert port_doc.pop("device") == "cpu"
    assert (jax_doc.pop("model"), port_doc.pop("model")) == (jax_dir, port_dir)
    assert abs(port_doc.pop("threshold") - jax_doc.pop("threshold")) <= 2e-6
    assert port_doc == jax_doc


def test_inspect_is_the_jax_clis_plus_device(both_clis):
    jax_doc, port_doc = both_clis[0]["inspect"]
    assert port_doc == {**jax_doc, "device": "cpu"}


def test_score_csv_is_the_jax_clis_where_the_scores_are_equal(both_clis):
    import numpy as np

    jax_lines, port_lines = both_clis[0]["score"]
    assert len(port_lines) == len(jax_lines) == 3001
    assert port_lines[0] == jax_lines[0] == "outlierScore,predictedLabel"
    jax_rows = np.array([[float(v) for v in line.split(",")] for line in jax_lines[1:]])
    port_rows = np.array([[float(v) for v in line.split(",")] for line in port_lines[1:]])
    assert np.abs(port_rows[:, 0] - jax_rows[:, 0]).max() <= 2e-6
    equal = port_rows[:, 0] == jax_rows[:, 0]
    assert equal.mean() > 0.5
    for i in np.nonzero(equal)[0]:
        assert port_lines[i + 1] == jax_lines[i + 1]


# --------------------------------------------------------------------------- #
# no card with the default device
# --------------------------------------------------------------------------- #


SUBCOMMANDS_WITH_A_MODEL = ["fit", "score", "inspect", "diagnose", "telemetry", "trace", "debug-bundle",
                            "monitor", "manage", "stream", "autotune"]


def _no_card_argv(name: str, missing: str) -> list:
    return {
        "fit": ["fit", "--input", missing, "--output", missing + ".out"],
        "score": ["score", "--model", missing, "--input", missing],
        "inspect": ["inspect", "--model", missing],
        "diagnose": ["diagnose", missing],
        "telemetry": ["telemetry", "--input", missing],
        "trace": ["trace", missing + ".json", "--input", missing],
        "debug-bundle": ["debug-bundle", missing + ".json", "--input", missing],
        "monitor": ["monitor", missing, "--input", missing],
        "manage": ["manage", missing, "--input", missing],
        "stream": ["stream", missing, "--source", missing],
        "autotune": ["autotune", "--warm", "--input", missing],
    }[name]


@pytest.mark.parametrize("name", SUBCOMMANDS_WITH_A_MODEL)
def test_no_card_with_the_default_device_raises_before_reading(name, tmp_path, capsys, monkeypatch):
    """The inputs do not exist: a subcommand that read one first would raise
    FileNotFoundError, not the missing card."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(_no_card_argv(name, str(tmp_path / "missing")))
    assert capsys.readouterr().out == ""
    assert os.listdir(tmp_path) == []


# --------------------------------------------------------------------------- #
# diagnose / monitor (tests/test_monitor.py::TestCli on the port)
# --------------------------------------------------------------------------- #


class TestMonitorCli:
    @pytest.fixture(scope="class")
    def model_and_csv(self, tmp_path_factory):
        import numpy as np

        from isoforest_tpu_torch import IsolationForest

        rng = np.random.default_rng(0)
        X = rng.normal(size=(3000, 4)).astype(np.float32)
        X[:50] += 5.0
        root = tmp_path_factory.mktemp("obs-cli")
        csv = root / "data.csv"
        np.savetxt(csv, X, delimiter=",")
        shifted = root / "shifted.csv"
        np.savetxt(shifted, X + 4.0, delimiter=",")
        model_dir = root / "model"
        IsolationForest(num_estimators=10, random_seed=1, device="cpu").fit(X).save(str(model_dir))
        return str(model_dir), str(csv), str(shifted)

    def test_diagnose_json(self, model_and_csv, capsys):
        model_dir, _, _ = model_and_csv
        assert main(["diagnose", model_dir, *CPU]) == 0
        diag = json.loads(capsys.readouterr().out)
        assert diag["num_trees"] == 10
        assert "feature_split_usage" in diag
        assert diag["device"] == "cpu"

    def test_diagnose_prometheus(self, model_and_csv, capsys):
        model_dir, _, _ = model_and_csv
        assert main(["diagnose", model_dir, "--format", "prometheus", *CPU]) == 0
        parsed = telemetry.parse_prometheus(capsys.readouterr().out)
        assert parsed["isoforest_forest_trees"][()] == 10.0

    def test_monitor_json_in_distribution(self, model_and_csv, capsys):
        model_dir, csv, _ = model_and_csv
        assert main(["monitor", model_dir, "--input", csv, *CPU]) == 0
        report = json.loads(capsys.readouterr().out)
        assert report["rows"] == 3000
        assert report["score"]["psi"] < 0.25
        assert report["drifted"] is False
        assert report["device"] == "cpu"

    def test_monitor_detects_shift_and_prometheus_format(self, model_and_csv, capsys):
        model_dir, _, shifted = model_and_csv
        rc = main(["monitor", model_dir, "--input", shifted, "--format", "prometheus", *CPU])
        assert rc == 0
        parsed = telemetry.parse_prometheus(capsys.readouterr().out)
        assert parsed["isoforest_score_drift_psi"][()] > 0.25

    def test_monitor_refuses_legacy_model(self, tmp_path, capsys):
        import numpy as np

        from isoforest_tpu_torch import IsolationForest

        X = np.random.default_rng(1).normal(size=(600, 3)).astype(np.float32)
        model = IsolationForest(num_estimators=4, random_seed=1, device="cpu").fit(X, baseline=False)
        model_dir = str(tmp_path / "legacy")
        model.save(model_dir)
        csv = str(tmp_path / "d.csv")
        np.savetxt(csv, X, delimiter=",")
        assert main(["monitor", model_dir, "--input", csv, *CPU]) == 2
        assert "_BASELINE.json" in capsys.readouterr().err


# --------------------------------------------------------------------------- #
# manage (tests/test_lifecycle.py::TestCli on the port)
# --------------------------------------------------------------------------- #

N_TREES = 12


class TestManageCli:
    @pytest.fixture(scope="class")
    def model_and_csv(self, tmp_path_factory):
        import numpy as np

        from isoforest_tpu_torch import IsolationForest

        rng = np.random.default_rng(0)
        X = rng.normal(size=(4000, 3)).astype(np.float32)
        X[:60] += 5.0
        root = tmp_path_factory.mktemp("lifecycle-cli")
        csv = root / "data.csv"
        np.savetxt(csv, X, delimiter=",")
        shifted = root / "shifted.csv"
        np.savetxt(shifted, X + 3.0 * np.std(X, axis=0, keepdims=True), delimiter=",")
        model_dir = root / "model"
        IsolationForest(num_estimators=N_TREES, random_seed=1, device="cpu").fit(X).save(str(model_dir))
        return str(model_dir), str(csv), str(shifted), str(root)

    def test_manage_swaps_on_drifted_csv(self, model_and_csv, capsys):
        model_dir, _, shifted, root = model_and_csv
        rc = main(["manage", model_dir, "--input", shifted, "--work-dir", os.path.join(root, "lc"),
                   "--debounce", "1", "--chunk-rows", "2000", "--min-window-rows", "512", "--window-rows", "4096",
                   *CPU])
        assert rc == 0
        summary = json.loads(capsys.readouterr().out)
        assert summary["generation"] == 2
        assert summary["retrains"] == {"swapped": 1}
        assert summary["rows"] == 4000
        assert summary["drift"]["score"]["psi"] < 0.25
        assert summary["last_validation"]["passed"] is True
        assert summary["device"] == "cpu"
        current = json.load(open(os.path.join(root, "lc", "CURRENT.json")))
        assert current["generation"] == 2

    def test_manage_stays_quiet_in_distribution(self, model_and_csv, capsys):
        model_dir, csv, _, root = model_and_csv
        rc = main(["manage", model_dir, "--input", csv, "--work-dir", os.path.join(root, "lc-quiet"),
                   "--chunk-rows", "1000", *CPU])
        assert rc == 0
        summary = json.loads(capsys.readouterr().out)
        assert summary["generation"] == 1
        assert summary["retrains"] == {}

    def test_manage_serves_metrics_on_port_0_and_stops(self, model_and_csv, capsys, monkeypatch):
        """``--port 0`` brings up the telemetry daemon for the run and stops
        it before the summary."""
        import urllib.request

        model_dir, csv, _, root = model_and_csv
        seen = {}
        serve = telemetry.serve

        def watched(*args, **kwargs):
            seen["server"] = serve(*args, **kwargs)
            with urllib.request.urlopen(f"http://127.0.0.1:{seen['server'].port}/healthz", timeout=30) as resp:
                seen["status"] = resp.status
            return seen["server"]

        monkeypatch.setattr(telemetry, "serve", watched)
        rc = main(["manage", model_dir, "--input", csv, "--work-dir", os.path.join(root, "lc-port"),
                   "--chunk-rows", "2000", "--port", "0", *CPU])
        assert rc == 0 and seen["status"] == 200
        assert json.loads(capsys.readouterr().out)["rows"] == 4000
        with pytest.raises(OSError):
            urllib.request.urlopen(f"http://127.0.0.1:{seen['server'].port}/healthz", timeout=5)

    def test_manage_refuses_legacy_model(self, tmp_path, capsys):
        import numpy as np

        from isoforest_tpu_torch import IsolationForest

        X = np.random.default_rng(1).normal(size=(600, 3)).astype(np.float32)
        model = IsolationForest(num_estimators=4, random_seed=1, device="cpu").fit(X, baseline=False)
        model_dir = str(tmp_path / "legacy")
        model.save(model_dir)
        csv = str(tmp_path / "d.csv")
        np.savetxt(csv, X, delimiter=",")
        assert main(["manage", model_dir, "--input", csv, *CPU]) == 2


# --------------------------------------------------------------------------- #
# stream (tests/test_stream.py::TestCli on the port)
# --------------------------------------------------------------------------- #

FEATURES = 3


class TestStreamCli:
    @pytest.fixture(autouse=True)
    def _signal_handlers(self):
        """``stream`` takes SIGTERM and SIGINT for its own stop: give them back."""
        import signal

        saved = {sig: signal.getsignal(sig) for sig in (signal.SIGTERM, signal.SIGINT)}
        yield
        for sig, handler in saved.items():
            signal.signal(sig, handler)

    @pytest.fixture(scope="class")
    def model_and_stream(self, tmp_path_factory):
        import numpy as np

        from isoforest_tpu_torch import IsolationForest

        rng = np.random.default_rng(0)
        root = tmp_path_factory.mktemp("stream-cli")
        X = rng.normal(size=(4000, FEATURES)).astype(np.float32)
        X[:60] += 5.0
        model_dir = root / "model"
        IsolationForest(num_estimators=N_TREES, random_seed=1, device="cpu").fit(X).save(str(model_dir))
        rows = 2400
        ts = np.linspace(0.0, 239.9, rows)
        Xs = rng.normal(size=(rows, FEATURES))
        Xs[rows // 2:] += 3.0  # shift halfway
        np.savetxt(root / "stream.csv", np.column_stack([ts, Xs]), delimiter=",")
        return str(model_dir), str(root / "stream.csv"), str(root)

    def test_stream_cli_end_to_end(self, model_and_stream, capsys):
        model_dir, csv, root = model_and_stream
        rc = main(["stream", model_dir, "--source", csv, "--window-s", "60", "--lateness-s", "5",
                   "--retrain-every", "2", "--min-window-rows", "256", "--min-rows", "256", "--window-rows", "2048",
                   "--work-dir", os.path.join(root, "lc"), *CPU])
        assert rc == 0
        summary = json.loads(capsys.readouterr().out)
        assert summary["rows"] == 2400
        assert summary["late_rows"] == 0
        assert summary["windows_closed"] >= 4
        assert summary["swaps"] >= 1
        assert summary["reservoir"] == "decay"  # the stream CLI default
        assert summary["rss_trajectory"]
        assert summary["device"] == "cpu"
        current = json.load(open(os.path.join(root, "lc", "CURRENT.json")))
        assert current["generation"] == summary["generation"]

    def test_stream_cli_ready_line_on_port_0(self, model_and_stream, capsys):
        """``--port 0``: a ready line with the daemon's URL and the device,
        then the summary; the daemon is stopped when the command returns."""
        import urllib.request

        model_dir, csv, root = model_and_stream
        rc = main(["stream", model_dir, "--source", csv, "--port", "0", "--retrain-every", "100",
                   "--work-dir", os.path.join(root, "lc-port"), *CPU])
        assert rc == 0
        ready_line, summary_text = capsys.readouterr().out.split("\n", 1)
        ready = json.loads(ready_line)
        assert ready["url"].startswith("http://127.0.0.1:") and ready["device"] == "cpu"
        assert json.loads(summary_text)["rows"] == 2400
        with pytest.raises(OSError):
            urllib.request.urlopen(ready["url"] + "/healthz", timeout=5)

    def test_stream_cli_requires_baseline(self, model_and_stream, tmp_path, capsys):
        import numpy as np

        from isoforest_tpu_torch import IsolationForest

        _, csv, _ = model_and_stream
        rng = np.random.default_rng(0)
        bare = IsolationForest(num_estimators=N_TREES, random_seed=1, device="cpu").fit(
            rng.normal(size=(512, FEATURES)), baseline=False)
        bare.save(str(tmp_path / "bare"))
        rc = main(["stream", str(tmp_path / "bare"), "--source", csv, *CPU])
        assert rc == 2
        assert "_BASELINE.json" in capsys.readouterr().err

    def test_manage_cli_decay_reservoir(self, model_and_stream, capsys):
        import numpy as np

        model_dir, _, root = model_and_stream
        rng = np.random.default_rng(1)
        shifted = rng.normal(size=(3000, FEATURES)) + 3.0
        np.savetxt(os.path.join(root, "shifted.csv"), shifted, delimiter=",")
        rc = main(["manage", model_dir, "--input", os.path.join(root, "shifted.csv"), "--work-dir",
                   os.path.join(root, "manage-lc"), "--debounce", "1", "--chunk-rows", "1500",
                   "--min-window-rows", "512", "--window-rows", "2048", "--reservoir", "decay", "--half-life-s",
                   "120", *CPU])
        assert rc == 0
        summary = json.loads(capsys.readouterr().out)
        assert summary["generation"] == 2


# --------------------------------------------------------------------------- #
# autotune (tests/test_autotune.py::TestCLI on the port)
# --------------------------------------------------------------------------- #


@pytest.fixture
def autotune(tmp_path, monkeypatch):
    """The tuner on, against an isolated table, with cheap probes."""
    from isoforest_tpu_torch import tuning

    path = tmp_path / "table.json"
    monkeypatch.setenv("ISOFOREST_TPU_AUTOTUNE", "1")
    monkeypatch.setenv("ISOFOREST_TPU_AUTOTUNE_PATH", str(path))
    monkeypatch.setenv("ISOFOREST_TPU_AUTOTUNE_REPS", "1")
    monkeypatch.setenv("ISOFOREST_TPU_AUTOTUNE_PROBE_ROWS", "512")
    monkeypatch.delenv("ISOFOREST_TPU_STRATEGY", raising=False)
    tuning.reset_cost_model()
    yield path
    tuning.reset_cost_model()


class TestAutotuneCli:
    def test_json_round_trips_persisted_table(self, autotune, capsys):
        import numpy as np

        from isoforest_tpu_torch import IsolationForest, tuning

        rng = np.random.default_rng(3)
        X = rng.normal(size=(700, 5)).astype(np.float32)
        X[:20] += 3.5
        std = IsolationForest(num_estimators=12, max_samples=64.0, random_seed=7, device="cpu").fit(X)
        tuning.resolve_decision(std.forest, X, std.num_samples)
        assert main(["autotune", "--format", "json"]) == 0
        printed = json.loads(capsys.readouterr().out)
        on_disk = json.loads(autotune.read_text())
        assert printed["entries"] == on_disk["entries"]
        assert printed["schema"] == on_disk["schema"]

    def test_warm_then_clear(self, autotune, capsys):
        rc = main(["autotune", "--warm", "--trees", "5", "--batch-sizes", "1024", "--format", "table", *CPU])
        assert rc == 0
        assert autotune.exists()
        captured = capsys.readouterr()
        assert "->" in captured.out  # human table lists the warmed entry
        assert _last_json(captured.err)["device"] == "cpu"
        assert main(["autotune", "--clear"]) == 0
        assert not autotune.exists()
        cleared = json.loads(capsys.readouterr().out)
        assert cleared["existed"] is True


# --------------------------------------------------------------------------- #
# telemetry / trace / debug-bundle (tests/test_telemetry.py on the port)
# --------------------------------------------------------------------------- #


class TestTelemetryCli:
    def test_cli_telemetry_json(self, capsys):
        assert main(["telemetry", "--rows", "256", "--trees", "5", *CPU]) == 0
        out = json.loads(capsys.readouterr().out)
        assert out["telemetry_enabled"] is True
        assert "isolation_forest.fit.grow" in out["spans"]
        assert "isoforest_scored_rows_total" in out["metrics"]

    def test_cli_telemetry_prometheus(self, capsys):
        rc = main(["telemetry", "--rows", "256", "--trees", "5", "--format", "prometheus", *CPU])
        assert rc == 0
        parsed = telemetry.parse_prometheus(capsys.readouterr().out)
        fit_rows = parsed["isoforest_fit_rows_total"]
        assert fit_rows[(("model", "standard"),)] >= 256

    def test_cli_trace_writes_the_scoring_trace(self, tmp_path, capsys):
        out = tmp_path / "trace.json"
        assert main(["trace", str(out), "--rows", "256", "--trees", "5", *CPU]) == 0
        summary = _last_json(capsys.readouterr().out)
        assert summary["root"] == "model.score" and summary["device"] == "cpu"
        doc = json.loads(out.read_text())
        assert any(e.get("name") == "model.score" for e in doc["traceEvents"])

    def test_cli_debug_bundle(self, tmp_path, capsys):
        out = tmp_path / "bundle.json"
        assert main(["debug-bundle", str(out), "--rows", "256", "--trees", "5", *CPU]) == 0
        summary = _last_json(capsys.readouterr().out)
        bundle = json.loads(out.read_text())
        assert summary["schema"] == bundle["schema"] and summary["traces"] >= 1
        assert summary["sections"] == sorted(k for k in bundle if k != "schema")


# --------------------------------------------------------------------------- #
# fit --source / score --source (tests/test_out_of_core.py::TestCliOutOfCore)
# --------------------------------------------------------------------------- #


class TestCliOutOfCore:
    def test_fit_and_score_via_source(self, tmp_path, capsys):
        import numpy as np

        from isoforest_tpu_torch import load_model
        from isoforest_tpu_torch.io import source as srcmod
        from isoforest_tpu_torch.io.outofcore import read_scores

        rng = np.random.default_rng(41)
        X = rng.normal(size=(6000, 5)).astype(np.float32)
        X[:60] += 6.0
        shard_dir = tmp_path / "shards"
        shard_dir.mkdir()
        bounds = [0, 1000, 2500, 5999, 6000]
        for i in range(4):
            srcmod.write_npy_shard(str(shard_dir / f"part-{i:03d}.npy"), X[bounds[i]:bounds[i + 1]])
        model_dir = str(tmp_path / "model")
        rc = main(["fit", "--source", str(shard_dir), "--output", model_dir, "--num-estimators", "10",
                   "--max-samples", "64", "--contamination", "0.02", "--random-seed", "23", *CPU])
        assert rc == 0
        summary = _last_json(capsys.readouterr().out)
        assert summary["sourceShards"] == 4
        assert summary["numTrees"] == 10

        sink = str(tmp_path / "scores")
        rc = main(["score", "--model", model_dir, "--source", str(shard_dir), "--output", sink, "--strategy", "walk",
                   *CPU])
        assert rc == 0
        out = _last_json(capsys.readouterr().out)
        assert out["sealed"] == 4 and out["device"] == "cpu"
        got = read_scores(sink, num_shards=4)
        model = load_model(model_dir, device="cpu")
        want = np.concatenate([model.score(X[bounds[i]:bounds[i + 1]], strategy="walk").numpy() for i in range(4)])
        assert np.array_equal(got, want)

        rc = main(["score", "--model", model_dir, "--source", str(shard_dir), "--output", sink, "--strategy", "walk",
                   "--resume", *CPU])
        assert rc == 0
        resumed = _last_json(capsys.readouterr().out)
        assert (resumed["sealed"], resumed["skipped"]) == (0, 4)
        assert np.array_equal(read_scores(sink, num_shards=4), got)
