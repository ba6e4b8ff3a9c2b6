"""What one cell is made of, found by name: its entry in ``BENCHMARK.json``,
``cells/<cell>.json`` (the configuration, the traffic mix and the cell's own
parameters), ``configs/<config>.json`` (the deployment's sizes, data,
forest and the limits of ``correct``), ``traffic/<mix>.json`` (the loop
and its parameters) and ``layer_metrics/<metric>.py`` (one reader a
per-layer metric). Nothing here branches on a cell's name."""

from __future__ import annotations

import importlib.util
import json
import os
import pathlib
from typing import Dict, List, NamedTuple

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def pin_caches() -> None:
    """Every build and kernel cache of the program at a fixed path inside
    the checkout, so that only a cell's first run there builds; to be called
    before the port is imported."""
    build = ROOT / "build"
    os.environ["ISOFOREST_TPU_TORCH_BUILD_DIR"] = str(build / "isoforest_tpu_torch")
    os.environ["ISOFOREST_TPU_AUTOTUNE_PATH"] = str(build / "portbench" / "autotune.json")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    mix: dict  # the traffic mix's parameters, the cell's own merged over them
    end_to_end: List[dict]  # BENCHMARK.json's metrics this cell reports
    per_layer: List[dict]


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, overrides: Dict[str, dict] = None) -> Cell:
    """The cell ``name`` (``cells/<name>.json``) with its files read and the
    metrics ``BENCHMARK.json`` has it report (none for a cell the benchmark
    does not list); ``overrides`` (the tests' small sizes) replaces keys of
    the ``"mix"`` and of the ``"config"``."""
    bench = benchmark()
    cell_file = load_json(HERE / "cells" / f"{name}.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is not None and (cell_file["config"], cell_file["traffic"]) != (entry["config"], entry["traffic"]):
        raise ValueError(f"cells/{name}.json names another configuration or mix than BENCHMARK.json")
    overrides = overrides or {}
    config = load_json(HERE / "configs" / f"{cell_file['config']}.json")
    config.update(overrides.get("config", {}))
    mix = load_json(HERE / "traffic" / f"{cell_file['traffic']}.json")
    mix.update(cell_file.get("params", {}))
    mix.update(overrides.get("mix", {}))
    listed = entry is not None
    return Cell(
        name=name,
        chips=int(entry["chips"]) if listed else 1,
        config=config,
        mix=mix,
        end_to_end=[m for m in bench["end_to_end"] if listed and _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if listed and _reports(m, name)],
    )


def reader(metric_name: str):
    """The module of ``layer_metrics/<metric_name>.py``: ``LAYER`` and
    ``read(ctx)`` (a number, or None where it finds nothing to read)."""
    path = HERE / "layer_metrics" / f"{metric_name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_layer_metric_{metric_name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
