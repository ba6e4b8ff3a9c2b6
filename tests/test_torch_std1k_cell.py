"""The 1000-tree standard forest of the benchmark's ``kddhttp-std1k``
deployment, on the CPU at a small size: the port's ``model.score`` over a
forest grown by the benchmark's own grower (``portbench/reference/forest.py``)
from ``kddcup_http_hard`` rows agrees with the benchmark's plain reference,
and the cell ``kddhttp-std1k.resident-10m`` resolves and runs correct."""

from __future__ import annotations

import pathlib
import sys
import time

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness, inputs, spec  # noqa: E402
from portbench.reference import score as ref_score  # noqa: E402


CELL = "kddhttp-std1k.resident-10m"
SEED = 2 ** 32 + 23
SMALL = {"mix": {"rows": 2048}, "config": {"trainingRows": 4000}}
NEW_METRICS = {"kernel_roofline_share.resident", "device_idle_share.resident", "walk_staged_share.resident"}


@pytest.fixture
def small_config():
    return spec.load_cell(CELL, SMALL).config


def test_the_port_scores_a_1000_tree_forest_as_the_reference_does(small_config):
    assert small_config["numEstimators"] == 1000 and small_config["kind"] == "standard"
    forest = inputs.grow_forest(small_config, seed=SEED, device="cpu")
    assert forest["feature"].shape == (1000, 511)
    X = inputs.scored_rows(small_config, 3000, seed=SEED, device="cpu", place="device")
    model = inputs.build_model(small_config, forest, "cpu")
    got = model.score(X, strategy="walk").to(torch.float64)
    want = ref_score.score(inputs.forest_tensors(forest, "cpu"), X, max_samples=small_config["maxSamples"])
    # a standard node's float32 compare is exact: only the float32 sum of
    # 1000 path lengths parts the port from the float64 reference
    assert float((got - want.scores).abs().max()) <= ref_score.ROW_TOLERANCE


def test_the_cell_resolves_to_its_files_and_reports_the_new_metrics():
    cell = spec.load_cell(CELL)
    assert cell.chips == 1 and cell.config["name"] == "kddhttp-std1k"
    assert cell.mix == {"loop": "bulk", "rows": 10_000_000, "place": "device"}
    assert cell.config["reduced"] == [] and cell.config["limits"] == spec.load_cell(
        "kddhttp-std.resident-10m").config["limits"]
    assert {m["name"] for m in cell.end_to_end} == {"score_rows_per_s", "setup_s"}
    assert NEW_METRICS <= {m["name"] for m in cell.per_layer}
    assert all(m["moves"] == "score_rows_per_s" for m in cell.per_layer)


def test_a_small_traced_run_of_the_cell_is_correct(monkeypatch, tmp_path):
    monkeypatch.setenv("ISOFOREST_TPU_STRATEGY", "walk")
    monkeypatch.setenv("ISOFOREST_TPU_AUTOTUNE_PATH", str(tmp_path / "autotune.json"))
    result = harness.run(CELL, SEED, 1.0, True, t_start=time.perf_counter(), device="cpu", require_card=False,
                         overrides=SMALL)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] > 0, result["checks"]
    assert all(check["value"] == 0 for check in result["checks"].values()), result["checks"]
    assert result["info"]["strategy"] == "walk"
    # on the CPU nothing reads a device trace or a kernel launch
    assert not NEW_METRICS & set(result["metrics"])
