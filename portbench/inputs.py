"""A cell's inputs, all from ``--seed``: the training table, the forest
(the "weights") and the scored rows, handed alike to the port and to the
reference; and the port's model over that forest, built through its public
constructors (no Avro: a 274-wide forest's host load takes tens of seconds)."""

from __future__ import annotations

import numpy as np
import torch

from .reference import data as ref_data
from .reference import forest as ref_forest


def grow_forest(config: dict, *, seed: int, device) -> dict:
    """The configuration's forest, grown in NumPy over a training table made
    from ``seed`` (stream ``"train"``) on ``device``."""
    train = ref_data.make_rows(config["data"], config["trainingRows"], seed=seed, stream="train", device=device)
    rng = np.random.default_rng(ref_data.sub_seed(seed, "forest"))
    forest = {"kind": config["kind"], "num_trees": config["numEstimators"], "max_samples": config["maxSamples"]}
    if config["kind"] == "extended":
        forest["extension_level"] = config["extensionLevel"]
    return ref_forest.grow(forest, train.cpu().numpy(), seed_rng=rng)


def scored_rows(config: dict, n: int, *, seed: int, device, place: str):
    """``n`` scored rows (stream ``"score"``), made on ``device`` and kept
    there (``place="device"``) or copied once to pageable host memory
    (``place="host"``, a NumPy array)."""
    rows = ref_data.make_rows(config["data"], n, seed=seed, stream="score", device=device)
    if place == "device":
        return rows
    if place == "host":
        host = rows.cpu().numpy()
        del rows
        return host
    raise ValueError(f"unknown place {place!r}")


def forest_tensors(forest: dict, device) -> dict:
    """The forest's arrays as tensors on ``device``, for the reference."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in forest.items()}


def build_model(config: dict, forest: dict, device):
    """The port's model over the benchmark's forest, on ``device``."""
    from isoforest_tpu_torch.io.interop import extended_forest_from_arrays, forest_from_arrays
    from isoforest_tpu_torch.models import ExtendedIsolationForestModel, IsolationForestModel
    from isoforest_tpu_torch.utils.params import ExtendedIsolationForestParams, IsolationForestParams

    common = dict(num_estimators=int(config["numEstimators"]), max_samples=float(config["maxSamples"]),
                  contamination=float(config["contamination"]), max_features=float(config["maxFeatures"]),
                  bootstrap=bool(config["bootstrap"]))
    width = int(config["numFeatures"])
    if config["kind"] == "standard":
        return IsolationForestModel(
            forest=forest_from_arrays(forest["feature"], forest["threshold"], forest["num_instances"], device=device),
            params=IsolationForestParams(**common), num_samples=int(config["maxSamples"]),
            num_features=width, total_num_features=width)
    return ExtendedIsolationForestModel(
        forest=extended_forest_from_arrays(forest["indices"], forest["weights"], forest["offset"],
                                           forest["num_instances"], device=device),
        params=ExtendedIsolationForestParams(extension_level=int(config["extensionLevel"]), **common),
        num_samples=int(config["maxSamples"]), num_features=width,
        extension_level=int(config["extensionLevel"]), total_num_features=width)
