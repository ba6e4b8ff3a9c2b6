#!/usr/bin/env python3
"""Drive the PyTorch port of the isolation forest on one NVIDIA GPU and check it.

Run from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit::

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: compile ``isoforest_tpu_torch/csrc/*.cu`` with ``nvcc``, one
   process per source, all started together;
3. parity: load the JAX-written mammography model
   (``tests/resources/torch_port/mammography_std``) on the card, score the
   11,183 rows with the walk and the dense kernel, and hold the scores to the
   JAX package's (max |delta| <= 2e-6, AUROC in [0.84, 0.90], equal labels
   away from the threshold);
4. full_size: 1,000,000 seeded rows through the loaded 100-tree model with
   each strategy, through ``model.score``, with every launch counter set to
   0 just before and read just after; then each kernel against its plain
   PyTorch version on the same inputs, and CUDA-event timings;
5. edges: seeded synthetic forests (F in {1, 12, 13, 17, 274}, T = 13 with
   a root-leaf tree, heights up to 12 for the walk and the dense kernel's
   fence, N in {1, 1023, 1025}, rows with NaN and +-inf): kernel against
   plain version for each;
6. serving: ``model.score`` latency on batches of 1, 64 and 4,096 rows,
   with ``strategy="auto"`` (the walk) and ``"dense"``.

Then a ``{"kernels": [...]}`` line, the ``nvidia-smi`` name and power-limit
line, and last ``{"ok": true, "device": {...}}``. Any failed check raises
and exits non-zero. With no CUDA card, or without the package beside it,
the script prints no result and exits 2.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
FIXTURE = ROOT / "tests" / "resources" / "torch_port" / "mammography_std"
MAMMOGRAPHY = ROOT / "tests" / "resources" / "mammography.csv"

# H100 SXM published peaks: HBM bytes/s and
# float32 operations/s outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12

FULL_ROWS = 1_000_000
SEED = 0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def require(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def auroc(scores, labels) -> float:
    """Rank AUROC with average ranks for ties (Mann-Whitney U)."""
    import numpy as np

    s = np.asarray(scores, np.float64)
    sorter = np.argsort(s, kind="mergesort")
    inv = np.empty_like(sorter)
    inv[sorter] = np.arange(len(s))
    ss = s[sorter]
    first = np.r_[True, ss[1:] != ss[:-1]]
    group = first.cumsum()[inv]
    bounds = np.r_[np.nonzero(first)[0], len(first)]
    ranks = 0.5 * (bounds[group] + bounds[group - 1] + 1)
    pos = np.asarray(labels) == 1
    n1, n0 = int(pos.sum()), int((~pos).sum())
    return float((ranks[pos].sum() - n1 * (n1 + 1) / 2) / (n1 * n0))


def time_ms(fn, reps: int = 7, inner: int = 1, warmup: int = 2) -> float:
    """Median over ``reps`` of CUDA-event time per call, ``inner`` calls back to back."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def main() -> int:
    if not (ROOT / "isoforest_tpu_torch").is_dir() or not FIXTURE.is_dir():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    try:
        import numpy as np
        import torch
    except ImportError as exc:
        print(f"chip_smoke: {exc}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from isoforest_tpu_torch import load_model
    from isoforest_tpu_torch.io.interop import forest_from_arrays
    from isoforest_tpu_torch.ops import _build, dense, walk
    from isoforest_tpu_torch.ops.traversal import standard_path_lengths
    from isoforest_tpu_torch.testing import random_heap_forest, rows
    from isoforest_tpu_torch.utils.math import score_from_path_length

    dev = torch.device("cuda")
    # plain float32 products only: nothing below may round through TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "torch_device_name": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # 2. build
    t0 = time.perf_counter()
    report = _build.build(ptxas_verbose=True)
    ptxas = [line.strip() for r in report.values() for line in r["log"].splitlines()
             if "Used" in line or ("spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line)]
    emit({"phase": "build", "wall_s": time.perf_counter() - t0,
          "per_source_s": {k: v["seconds"] for k, v in report.items()}, "ptxas": ptxas})

    # 3. parity with the JAX package on the committed fixture
    data = np.loadtxt(MAMMOGRAPHY, delimiter=",", comments="#").astype(np.float32)
    X_m, y_m = data[:, :-1], data[:, -1]
    jax_scores = np.load(FIXTURE / "jax_scores.npy")
    model = load_model(str(FIXTURE / "model"))
    require(model.device.type == "cuda", f"model loaded on {model.device}")
    thr = model.outlier_score_threshold
    parity = {"phase": "parity", "rows": len(X_m), "trees": model.forest.num_trees,
              "heap_slots": model.forest.max_nodes, "threshold": thr}
    for strategy in ("walk", "dense"):
        s = model.score(X_m, strategy=strategy).cpu().numpy()
        err = float(np.abs(s - jax_scores).max())
        auc = auroc(s, y_m)
        away = np.abs(s - thr) > 2e-6
        labels = model.predict(torch.from_numpy(s)).numpy()
        same = bool((labels[away] == (jax_scores[away] >= thr)).all())
        parity[strategy] = {"max_abs_err": err, "auroc": auc, "labels_equal": same,
                            "outliers": int(labels.sum())}
        require(s.shape == jax_scores.shape and np.isfinite(s).all(), f"{strategy}: bad scores")
        require(err <= 2e-6, f"{strategy}: max |score - jax| = {err} > 2e-6")
        require(0.84 <= auc <= 0.90, f"{strategy}: AUROC {auc} outside [0.84, 0.90]")
        require(same, f"{strategy}: labels differ from the JAX package's")
    emit(parity)

    # 4. full size: the main path, then each kernel against its plain version
    rng = np.random.default_rng(SEED)
    idx = rng.integers(0, len(X_m), FULL_ROWS)
    jitter = rng.normal(0.0, 0.01, (FULL_ROWS, X_m.shape[1])).astype(np.float32)
    X_big = (X_m[idx] + jitter * X_m.std(axis=0)).astype(np.float32)
    walk.walk_sum.launches = 0
    dense.dense_mean.launches = 0
    t0 = time.perf_counter()
    s_walk = model.score(X_big, strategy="walk")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    s_dense = model.score(X_big, strategy="dense")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = {"walk": walk.walk_sum.launches, "dense": dense.dense_mean.launches}
    require(launches["walk"] > 0 and launches["dense"] > 0, f"a kernel did not launch: {launches}")
    for name, s in (("walk", s_walk), ("dense", s_dense)):
        require(tuple(s.shape) == (FULL_ROWS,) and bool(torch.isfinite(s).all())
                and bool(((s > 0) & (s <= 1)).all()), f"{name}: bad full-size scores")
    score_gap = float((s_walk - s_dense).abs().max())
    require(score_gap <= 2e-6, f"walk and dense scores differ by {score_gap}")

    Xd = torch.from_numpy(X_big).to(dev)
    wt = walk.walk_tables(model.forest)
    dt = dense.pack_standard(model.forest)
    n, f = Xd.shape
    t_n, m = dt.value.shape
    walk_err = float((walk.walk_sum(Xd, wt) - walk.walk_sum_plain(Xd, wt)).abs().max())
    dense_err = float((dense.dense_mean(Xd, dt) - dense.dense_mean_plain(Xd, dt)).abs().max())
    require(walk_err <= 1e-5, f"walk kernel vs plain: {walk_err}")
    require(dense_err <= 1e-5, f"dense kernel vs plain: {dense_err}")
    times = {
        "walk_ms": time_ms(lambda: walk.walk_sum(Xd, wt), inner=10),
        "walk_plain_ms": time_ms(lambda: walk.walk_sum_plain(Xd, wt), reps=5),
        "dense_ms": time_ms(lambda: dense.dense_mean(Xd, dt), inner=10),
        "dense_plain_ms": time_ms(lambda: dense.dense_mean_plain(Xd, dt), reps=5),
    }
    # Bounds from this run's inputs. Both kernels compute one function, each
    # row's path length through the forest (walk_sum the sum over trees,
    # dense_mean the mean), so both carry that function's bound. Bytes: X
    # read once, the kernel's tables read once, the f32[N] result written
    # once. Operations (float32): what these rows need, one compare per
    # internal slot a row visits plus one add per (row, tree), and for the
    # mean one divide per row. The dense algorithm compares at every slot
    # of every tree; that count is printed as dense_algorithm_ops_ms, the
    # time the card needs for it at peak, beside the bound and not as one.
    internal = model.forest.feature >= 0
    visited = torch.zeros((), dtype=torch.float64, device=dev)
    for t in range(t_n):
        node = torch.zeros(n, dtype=torch.long, device=dev)
        for _ in range(model.forest.height):
            inside = internal[t][node]
            visited += inside.sum()
            step = Xd.gather(1, wt.feature[t][node].long()[:, None])[:, 0] >= wt.threshold[t][node]
            node = torch.where(inside, 2 * node + 1 + step.long(), node)
    x_bytes, out_bytes = n * f * 4, n * 4
    walk_bytes = x_bytes + out_bytes + 3 * t_n * m * 4
    dense_bytes = x_bytes + out_bytes + 2 * t_n * m * 4
    path_ops = float(visited) + n * t_n

    def bound(nbytes, ops):
        by_bytes, by_ops = nbytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_F32_OPS_PER_S * 1e3
        return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")

    walk_bound, walk_by = bound(walk_bytes, path_ops)
    dense_bound, dense_by = bound(dense_bytes, path_ops + n)
    dense_algorithm_ops_ms = (float(n) * t_n * m + 2.0 * n * t_n) / PEAK_F32_OPS_PER_S * 1e3
    emit({"phase": "full_size", "rows": n, "features": f, "trees": t_n, "heap_slots": m,
          "launches": launches, "score_walk_s": t1 - t0, "score_dense_s": t2 - t1,
          "walk_vs_dense_max_abs_score": score_gap,
          "walk_kernel_vs_plain_max_abs_sum": walk_err,
          "dense_kernel_vs_plain_max_abs_mean": dense_err,
          "mean_internal_visits_per_row_tree": float(visited) / (n * t_n),
          **times,
          "walk_rows_per_s": n / times["walk_ms"] * 1e3,
          "dense_rows_per_s": n / times["dense_ms"] * 1e3,
          "walk_bound_ms": walk_bound, "walk_bound_by": walk_by,
          "dense_bound_ms": dense_bound, "dense_bound_by": dense_by,
          "dense_algorithm_ops_ms": dense_algorithm_ops_ms})

    # where one full-size model.score call spends its time: device activity
    # by name from torch.profiler, beside the call's wall time
    breakdown = {}
    for strategy in ("walk", "dense"):
        model.score(X_big, strategy=strategy)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model.score(X_big, strategy=strategy)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        device = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                device[e.name] = device.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
        top = sorted(device.items(), key=lambda kv: -kv[1])[:6]
        breakdown[strategy] = {"wall_ms": wall_ms, "device_ms": sum(device.values()),
                               "device_busy_share": sum(device.values()) / wall_ms,
                               "top_device_ms": [[k[:80], v] for k, v in top]}
    emit({"phase": "breakdown", "rows": n, **breakdown})

    # 5. edges: synthetic forests, kernel against plain version
    cases = [
        {"features": 1, "height": 8, "rows": 1025},
        {"features": 12, "height": 8, "rows": 1023},
        {"features": 13, "height": 8, "rows": 1025},
        {"features": 17, "height": 6, "rows": 1023},
        {"features": 274, "height": 8, "rows": 1},
        {"features": 6, "height": dense.DENSE_MAX_HEIGHT, "rows": 1025},
        {"features": 6, "height": dense.DENSE_MAX_HEIGHT + 1, "rows": 1023},
        {"features": 5, "height": 12, "rows": 1025},
    ]
    edges = []
    for case in cases:
        Xe = rows(rng, case["rows"], case["features"])
        forest = forest_from_arrays(*random_heap_forest(rng, 13, case["height"], case["features"], 0.85))
        xe = torch.from_numpy(Xe).to(dev)
        wte = walk.walk_tables(forest)
        w_err = float((walk.walk_sum(xe, wte) - walk.walk_sum_plain(xe, wte)).abs().max())
        g_err = float((walk.path_lengths_walk(xe, wte) - standard_path_lengths(forest, xe)).abs().max())
        row = dict(case, trees=13, walk_vs_plain=w_err, walk_vs_gather=g_err)
        require(w_err <= 1e-5 and g_err <= 1e-5, f"walk edge case {row}")
        if case["height"] <= dense.DENSE_MAX_HEIGHT:
            dte = dense.pack_standard(forest)
            d_err = float((dense.dense_mean(xe, dte) - dense.dense_mean_plain(xe, dte)).abs().max())
            row["dense_vs_plain"] = d_err
            require(d_err <= 1e-5, f"dense edge case {row}")
        else:
            tables = dense.pack_standard(forest)
            try:
                dense.dense_mean(xe, tables)
            except ValueError as exc:
                row["dense_fence"] = str(exc)
            else:
                fail(f"dense kernel accepted height {case['height']}")
        edges.append(row)
    emit({"phase": "edges", "cases": edges})

    # 6. serving-sized batches through model.score (host clock, synchronised)
    serving = {}
    for strategy in ("auto", "dense"):
        for rows in (1, 64, 4096):
            batch = X_big[:rows]
            for _ in range(3):
                model.score(batch, strategy=strategy)
            lat = []
            for _ in range(21):
                t0 = time.perf_counter()
                model.score(batch, strategy=strategy).cpu()
                lat.append((time.perf_counter() - t0) * 1e3)
            serving[f"{strategy}_{rows}"] = {"median_ms": statistics.median(lat), "max_ms": max(lat)}
    emit({"phase": "serving", "latency": serving})

    # end-to-end sanity: the card's scores agree with the gather reference on
    # a slice of the full-size rows
    ref = score_from_path_length(standard_path_lengths(model.forest, Xd[:4096]), model.num_samples)
    require(float((ref - s_walk[:4096]).abs().max()) <= 2e-6, "walk scores vs gather reference")

    emit({"kernels": [
        {"name": "walk_sum", "route": "cuda", "source": "isoforest_tpu_torch/csrc/walk.cu",
         "replaces": "isoforest_tpu/ops/pallas_walk.py:311", "launches": launches["walk"],
         "max_abs_err": walk_err, "ms": times["walk_ms"], "plain_ms": times["walk_plain_ms"],
         "bound_ms": walk_bound, "bound_by": walk_by, "library_ms": None},
        {"name": "dense_mean", "route": "cuda", "source": "isoforest_tpu_torch/csrc/dense.cu",
         "replaces": "isoforest_tpu/ops/pallas_traversal.py:277", "launches": launches["dense"],
         "max_abs_err": dense_err, "ms": times["dense_ms"], "plain_ms": times["dense_plain_ms"],
         "bound_ms": dense_bound, "bound_by": dense_by, "library_ms": None},
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
