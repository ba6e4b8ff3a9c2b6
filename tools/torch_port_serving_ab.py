#!/usr/bin/env python3
"""Time ``model.score`` of the PyTorch port against an earlier tree of it,
in turns, on a CUDA card.

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit::

    python3 tools/torch_port_serving_ab.py --extract-old REV   # where git is
    python3 tools/torch_port_serving_ab.py

``--extract-old REV`` writes the package as it was at git revision ``REV``
to ``build/serving_ab/old/`` and exits; the copy travels with the checkout
to a machine without git. The second command measures the old tree and
this one in turns (old, new, new, old), each run in a process of its own
that imports its tree's package (and builds its kernels under that tree's
``build/``). Each run loads both committed fixture models
(``tests/resources/torch_port/mammography_std`` and ``mammography_eif``)
and, for ``auto``, ``walk`` and ``dense``:

* the median host-clock latency of ``model.score`` of 1, 64 and 4,096 host
  rows (51 calls after 5 warm-ups, each synchronised by the copy of the
  scores back) and of 1,000,000 host rows (15 calls, synchronised);
* torch.profiler around one warm 1,000,000-row call: the call's wall time,
  its device time by activity (spans' user annotations left out) and the
  device's busy share;
* cProfile's top host functions over 200 one-row ``auto`` calls.

The rows are ``chip_smoke.py``'s: the mammography rows resampled with
seeded jitter. The port's autotuner probes cold in every run (a fresh table
under ``build/``); the old tree may have none. One JSON line per run, then
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import shutil
import statistics
import subprocess
import sys
import tarfile
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
OLD = ROOT / "build" / "serving_ab" / "old"
RESOURCES = ROOT / "tests" / "resources"
FULL_ROWS = 1_000_000
STRATEGIES = ("auto", "walk", "dense")


def extract_old(rev: str) -> None:
    """Write the package at ``rev`` to ``build/serving_ab/old/`` (needs git)."""
    shutil.rmtree(OLD, ignore_errors=True)
    OLD.mkdir(parents=True)
    with tempfile.TemporaryFile() as tar:
        subprocess.run(["git", "archive", rev, "isoforest_tpu_torch"], cwd=ROOT, stdout=tar, check=True)
        tar.seek(0)
        tarfile.open(fileobj=tar).extractall(OLD, filter="data")


def rows():
    import numpy as np

    data = np.loadtxt(RESOURCES / "mammography.csv", delimiter=",", comments="#").astype(np.float32)
    X_m = data[:, :-1]
    rng = np.random.default_rng(0)
    idx = rng.integers(0, len(X_m), FULL_ROWS)
    jitter = rng.normal(0.0, 0.01, (FULL_ROWS, X_m.shape[1])).astype(np.float32)
    return (X_m[idx] + jitter * X_m.std(axis=0)).astype(np.float32)


def profile(fn) -> dict:
    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            device[e.name[:60]] = device.get(e.name[:60], 0.0) + e.time_range.elapsed_us() / 1e3
    total = sum(device.values())
    return {"wall_ms": wall_ms, "device_ms": total, "device_busy_share": total / wall_ms,
            "device_ms_by_name": sorted(device.items(), key=lambda kv: -kv[1])[:6]}


def child(tree: str) -> None:
    import cProfile
    import io
    import pstats

    sys.path.insert(0, tree)
    os.environ["ISOFOREST_TPU_AUTOTUNE_PATH"] = str(ROOT / "build" / f"serving_ab_{os.getpid()}.json")
    import torch

    from isoforest_tpu_torch import load_model

    assert pathlib.Path(sys.modules["isoforest_tpu_torch"].__file__).resolve().is_relative_to(pathlib.Path(tree).resolve())
    X = rows()
    out = {"tree": tree}
    for kind in ("mammography_std", "mammography_eif"):
        model = load_model(str(RESOURCES / "torch_port" / kind / "model"))
        res = {}
        for strategy in STRATEGIES:
            for n in (1, 64, 4096, FULL_ROWS):
                batch = X[:n]
                reps = 15 if n == FULL_ROWS else 51
                for _ in range(5):
                    model.score(batch, strategy=strategy)
                lat = []
                for _ in range(reps):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    model.score(batch, strategy=strategy).cpu()
                    lat.append((time.perf_counter() - t0) * 1e3)
                res[f"{strategy}_{n}_ms"] = statistics.median(lat)
            res[f"{strategy}_1m_profile"] = profile(lambda: model.score(X, strategy=strategy))
        prof = cProfile.Profile()
        prof.enable()
        for _ in range(200):
            model.score(X[:1]).cpu()
        prof.disable()
        text = io.StringIO()
        pstats.Stats(prof, stream=text).sort_stats("cumulative").print_stats(18)
        res["one_row_auto_cprofile"] = [line.strip()[:140] for line in text.getvalue().splitlines()
                                        if "(" in line and ")" in line][:18]
        out[kind] = res
    print(json.dumps(out), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--extract-old", metavar="REV")
    parser.add_argument("--child", metavar="TREE")
    args = parser.parse_args()
    if args.extract_old:
        extract_old(args.extract_old)
        return 0
    if args.child:
        child(args.child)
        return 0
    if not (OLD / "isoforest_tpu_torch").is_dir():
        print(f"no old tree under {OLD}: run with --extract-old REV first", file=sys.stderr)
        return 2
    for tree in (OLD, ROOT, ROOT, OLD):
        subprocess.run([sys.executable, __file__, "--child", str(tree)], check=True, timeout=900)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
