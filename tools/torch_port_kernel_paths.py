#!/usr/bin/env python3
"""Time variants of the EIF kernels against the committed sources, on a CUDA card.

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit::

    python3 tools/torch_port_kernel_paths.py

Each variant is a textual edit of a copy of a kernel source, built under
``build/``, that takes another data path: the walk (``csrc/ext_walk.cu``)
reading its rows and tables through the read-only path (``__ldg``) instead
of plain loads; the sparse and the dense-table kernel
(``csrc/ext_dense.cu``) reading x[f] through L1 instead of the block's
shared-memory tile; the sparse kernel testing every coordinate for the
merged-away marker -1 instead of ending the node's terms at the first one.
The script swaps each variant into the port's wrapper and times it against
the committed build at the shapes of the main path of ``chip_smoke.py``:
the mammography EIF (100 trees, height 8, k = 6) on 1,000,000 rows for the
walk and the sparse kernel, a seeded F = k = 274 forest on 65,536 rows for
the dense-table kernel. Every variant must give the committed build's
result bit for bit. Times are CUDA-event medians, taken in turns
(committed, variant, variant, committed).

It also traces one warm ``model.score`` of the standard and of the EIF
fixture model, in turns, and reports whether each trace holds the
host-to-device copy of the rows, beside the copy's own CUDA-event time.

One JSON line per measurement, then the ``nvidia-smi`` name and power
limit as the last line.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

VARIANT_DIR = ROOT / "build" / "kernel_paths"
STD_MODEL = ROOT / "tests" / "resources" / "torch_port" / "mammography_std" / "model"
EIF_MODEL = ROOT / "tests" / "resources" / "torch_port" / "mammography_eif" / "model"
MAMMOGRAPHY = ROOT / "tests" / "resources" / "mammography.csv"
ROWS, HIGH_DIM_ROWS, SEED = 1_000_000, 65_536, 0

# variant -> (library, kernel it is timed on, [(text in the source, replacement), ...])
VARIANTS = {
    "walk_reads_through_ldg": ("ext_walk", "ext_walk_sum", [
        ("float lv = t_leaf[0];", "float lv = __ldg(t_leaf);"),
        ("dot = __fmul_rn(x[ni[1]], nw[1]);", "dot = __fmul_rn(__ldg(x + __ldg(ni + 1)), __ldg(nw + 1));"),
        ("dot = __fmaf_rn(x[ni[0]], nw[0], dot);", "dot = __fmaf_rn(__ldg(x + __ldg(ni)), __ldg(nw), dot);"),
        ("dot = __fmaf_rn(x[ni[q]], nw[q], dot);", "dot = __fmaf_rn(__ldg(x + __ldg(ni + q)), __ldg(nw + q), dot);"),
        ("(dot >= t_off[node] ? 1 : 0);", "(dot >= __ldg(t_off + node) ? 1 : 0);"),
        ("lv = t_leaf[node];", "lv = __ldg(t_leaf + node);"),
    ]),
    "sparse_x_through_l1": ("ext_dense", "ext_sparse_mean", [
        ("  while (b > 32 && (long long)f * b * 4 > kMaxTileBytes) b /= 2;\n",
         "  if (kDense) while (b > 32 && (long long)f * b * 4 > kMaxTileBytes) b /= 2;\n"),
        ("  const bool smem_x = (long long)f * b * 4 <= kMaxTileBytes;\n",
         "  const bool smem_x = kDense && (long long)f * b * 4 <= kMaxTileBytes;\n"),
    ]),
    "sparse_tests_every_coordinate": ("ext_dense", "ext_sparse_mean", [
        ("if (f < 0) break;  // merged away, and so are the rest\n              dot = __fmaf_rn(",
         "if (f >= 0) dot = __fmaf_rn("),
    ]),
    "dense_x_through_l1": ("ext_dense", "ext_dense_mean", [
        ("  while (b > 32 && (long long)f * b * 4 > kMaxTileBytes) b /= 2;\n", ""),
        ("  const bool smem_x = (long long)f * b * 4 <= kMaxTileBytes;\n", "  const bool smem_x = false;\n"),
    ]),
}

def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def build_variants() -> dict:
    """``{variant: path}`` of the libraries, all nvcc started together."""
    from isoforest_tpu_torch.ops import _build

    VARIANT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for variant, (name, _, edits) in VARIANTS.items():
        edited = (_build.CSRC_DIR / _build.SOURCES[name]).read_text()
        for old, new in edits:
            if edited.count(old) != 1:
                raise SystemExit(f"{_build.SOURCES[name]}: the text to edit for {variant} is not there once: {old!r}")
            edited = edited.replace(old, new)
        src = VARIANT_DIR / f"{name}-{variant}.cu"
        src.write_text(edited)
        lib = VARIANT_DIR / f"lib{name}-{variant}.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)]
        procs[variant] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for key, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {key}:\n{log}")
        libs[key] = lib
    return libs


def load_variant(path: pathlib.Path, signatures) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in signatures.items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare_paths(libs, X_big, eif_model) -> None:
    import numpy as np
    import torch

    from isoforest_tpu_torch.io.interop import extended_forest_from_arrays
    from isoforest_tpu_torch.ops import _build, ext_dense, ext_walk
    from isoforest_tpu_torch.testing import random_extended_forest, rows

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 1)
    f5 = extended_forest_from_arrays(*random_extended_forest(rng, 100, 8, 274, 274, split_p=1.0))
    X5 = torch.from_numpy(rows(rng, HIGH_DIM_ROWS, 274)).to(dev)
    Xd = torch.from_numpy(X_big).to(dev)
    wt = ext_walk.walk_tables_extended(eif_model.forest)
    st = ext_dense.sparse_hyperplane_tables(eif_model.forest)
    dt = ext_dense.dense_hyperplane_table(f5)
    calls = {
        "ext_walk_sum": (lambda: ext_walk.ext_walk_sum(Xd, wt), ext_walk._SIGNATURES, 9),
        "ext_sparse_mean": (lambda: ext_dense.ext_sparse_mean(Xd, st), ext_dense._SIGNATURES, 7),
        "ext_dense_mean": (lambda: ext_dense.ext_dense_mean(X5, dt), ext_dense._SIGNATURES, 3),
    }
    _build.build(["ext_walk", "ext_dense"])
    for variant, (name, kernel, _) in VARIANTS.items():
        call, signatures, reps = calls[kernel]
        committed = load_variant(_build.library_path(name), signatures)
        lib = load_variant(libs[variant], signatures)
        runs = {"committed": [], variant: []}
        outputs = {}
        for which, chosen in (("committed", committed), (variant, lib), (variant, lib), ("committed", committed)):
            _build._LIBS[name] = chosen
            outputs[which] = call()
            runs[which].append(time_ms(call, reps))
        _build._LIBS[name] = committed
        equal = bool(torch.equal(outputs["committed"], outputs[variant]))
        emit({"kernel": kernel, "variant": variant, "bitwise_equal": equal,
              "committed_ms": runs["committed"], "variant_ms": runs[variant],
              "variant_over_committed": statistics.mean(runs[variant]) / statistics.mean(runs["committed"])})
        if not equal:
            raise SystemExit(f"{kernel} {variant}: the result differs from the committed build's")


def trace_copies(X_big, std_model, eif_model) -> None:
    """Whether torch.profiler's trace of one warm ``model.score`` holds the
    host-to-device copy of X, per model, in turns, beside the copy timed
    alone on CUDA events."""
    import torch

    dev = torch.device("cuda")
    copy_ms = time_ms(lambda: torch.from_numpy(X_big).to(dev), reps=7)
    for label, model in (("std", std_model), ("eif", eif_model), ("std", std_model), ("eif", eif_model)):
        model.score(X_big, strategy="walk")
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model.score(X_big, strategy="walk")
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        device = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                device[e.name[:60]] = device.get(e.name[:60], 0.0) + e.time_range.elapsed_us() / 1e3
        emit({"trace": label, "wall_ms": wall_ms, "device_ms_by_name": device,
              "htod_in_trace": any("HtoD" in k for k in device), "copy_alone_ms": copy_ms})


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_port_kernel_paths: no CUDA device is available", file=sys.stderr)
        return 2
    from isoforest_tpu_torch import load_model

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    libs = build_variants()
    emit({"phase": "build_variants", "wall_s": time.perf_counter() - t0, "variants": len(libs)})
    data = np.loadtxt(MAMMOGRAPHY, delimiter=",", comments="#").astype(np.float32)
    X_m = data[:, :-1]
    rng = np.random.default_rng(SEED)
    idx = rng.integers(0, len(X_m), ROWS)
    jitter = rng.normal(0.0, 0.01, (ROWS, X_m.shape[1])).astype(np.float32)
    X_big = (X_m[idx] + jitter * X_m.std(axis=0)).astype(np.float32)
    std_model, eif_model = load_model(str(STD_MODEL)), load_model(str(EIF_MODEL))
    trace_copies(X_big, std_model, eif_model)
    compare_paths(libs, X_big, eif_model)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
