"""The benchmark's files against its contract: everything BENCHMARK.json
names resolves to a file by name, names and units use the allowed
characters, every per-layer metric's cells report what it moves, and no
module imports JAX, the JAX package or, under ``reference/``, the port."""

import ast
import json
import os
import pathlib
import re
import subprocess
import sys

import pytest

from portbench import harness, loops, spec

BENCH = spec.benchmark()
HERE = spec.HERE
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "isoforest_tpu"}


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    # 24 cells at this length fit the check's 43,200 s
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_every_entry_resolves_to_its_file_by_name():
    for c in BENCH["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        config = spec.load_json(spec.ROOT / c["file"])
        assert config["source"] == c["source"] and config["reduced"] == c["reduced"]
        assert set(config["limits"]) == {"max_excess", "rows_off", "missing"}
    for w in BENCH["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert spec.load_json(HERE / "cells" / f"{w['name']}.json")["why"] == w["why"]
        assert (HERE / "traffic" / f"{w['traffic']}.json").is_file()
    for m in BENCH["per_layer"]:
        module = spec.reader(m["name"])
        assert module.LAYER == m["layer"] and callable(module.read)
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


def test_names_units_and_texts():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append(entry["name"])
    assert len(names) == len(set(names))
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert TEXT.match(w["why"])
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(BENCH["workloads"])
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert TEXT.match(c["source"]) and TEXT.match(c["why"]) and all(NAME.match(k) for k in c["reduced"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert TEXT.match(m["layer"])
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        if m["name"].split(".")[0].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_each_per_layer_metrics_cells_report_what_it_moves():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", sorted(cells)):
            assert cell in cells
            assert "workloads" not in moved or cell in moved["workloads"], (m["name"], cell)
    for cell in cells:
        assert any(m["name"] != "setup_s" and cell in m.get("workloads", cells) for m in BENCH["end_to_end"])
        assert any(cell in m.get("workloads", cells) for m in BENCH["per_layer"])


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_nothing_imports_jax_or_the_jax_package():
    files = sorted(HERE.rglob("*.py"))
    assert files
    for path in files:
        found = set(_imports(path)) & FORBIDDEN
        assert not found, f"{path} imports {found}"


def test_the_reference_imports_nothing_of_the_port():
    for path in sorted((HERE / "reference").rglob("*.py")):
        assert "isoforest_tpu_torch" not in set(_imports(path)), path


def test_the_jax_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "isoforest_tpu_torch_fake", sys)
    assert harness.jax_modules() == [m for m in harness.jax_modules() if m in FORBIDDEN]
    assert "isoforest_tpu_torch_fake" not in harness.jax_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert "jaxlib" in harness.jax_modules()


def test_a_run_without_a_card_prints_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", HOME=str(tmp_path))
    done = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload", BENCH["workloads"][0]["name"],
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300)
    assert done.returncode != 0
    assert done.stdout.strip() == ""


@pytest.mark.card
def test_a_cell_runs_on_the_card(tmp_path):
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    done = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload", BENCH["workloads"][0]["name"],
                           "--seed", "4242", "--seconds", "2", "--trace", "0"],
                          cwd=str(spec.ROOT), capture_output=True, text=True, timeout=900)
    assert done.returncode == 0, done.stderr[-2000:]
    result = json.loads(done.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"


def test_every_cell_file_resolves_and_every_reader_is_listed():
    """Every cell file (those BENCHMARK.json lists, and the measured cell
    it leaves out, which the CPU tests run) resolves to its configuration,
    its mix and the mix's ``loops/<loop>.py``; every reader is listed."""
    assert {p.stem for p in (HERE / "layer_metrics").glob("*.py")} == {m["name"] for m in BENCH["per_layer"]}
    for path in sorted((HERE / "cells").glob("*.json")):
        cell = spec.load_cell(path.stem)
        assert TEXT.match(spec.load_json(path)["why"])
        loop = loops.load(cell.mix["loop"])
        assert all(callable(getattr(loop, name)) for name in ("warm", "window", "close"))
