#!/usr/bin/env python3
"""Time other data paths and earlier designs of the kernels against the
committed sources, on a CUDA card.

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit::

    python3 tools/torch_port_kernel_paths.py --extract-old REV   # where git is
    python3 tools/torch_port_kernel_paths.py
    python3 tools/torch_port_kernel_paths.py --dense-table   # the dense-table kernel alone

``--extract-old REV`` writes the package and ``chip_smoke.py`` as they
were at git revision ``REV`` to ``build/kernel_paths/old/`` and exits; the
copy travels with the checkout to a machine without git. The second
command then builds that tree's path kernels beside the committed ones:
its ``csrc/walk.cu``, the standard walk over heap tables staged tile by
tile in shared memory, and its ``csrc/ext_walk.cu``, the two EIF path
kernels on the walk core over the records that ``csrc/path_walk.cu`` now
shares with the standard walk. It times each earlier design against the
committed one in turns (old, new, new, old) at the shapes of the main path
of ``chip_smoke.py``: the mammography standard model and EIF (100 trees,
height 8; the EIF k = 6) and 1,000,000 rows, the standard walk's heap
tables rebuilt from the forest. Each pair must agree bit for bit. It also
measures ``chip_smoke.py``'s serving latency (``model.score`` of 1, 64 and
4,096 rows, ``auto`` and ``dense``, both fixture models) of the old tree
and of this one, six runs each, in turns that alternate which runs first,
each in a process of its own.

Each variant is a textual edit of a copy of a kernel source, built under
``build/``, that takes another data path or another size: the EIF path
kernels (``csrc/path_walk.cu``) reading x[f] through L1 instead of the
block's shared-memory row tile, walking 2 rows a thread, interleaved,
instead of 1 (a patch the script holds, ``TWO_ROW_WALK``), and reading
each record's 16-byte chunks as plain loads instead of through the
read-only path (``__ldg``); the standard walk's bulk batches through the
core's kernel (records through ``__ldg``, blocks of 128, 256 or 1,024
threads) instead of the kernel that stages the forest's records in shared
memory, and that staged kernel with blocks of 512 threads instead of 1,024
or reading x through L1 instead of its row tile; the standard dense kernel
(``csrc/dense.cu``) with 8 warps a block instead of 4, and with its 32-row
loop bounded by the warp's rows and unrolled 8 times instead of fully; the
dense-table kernel (``csrc/ext_gemm.cu``) in its fully dense form with
128-slot or 256-slot column tiles at every height instead of the width it
picks from the tree, with 192-slot tiles where it takes 256, held to the
registers of two blocks an SM, with 8-feature chunks instead of 16, and
with a 2-stage ring instead of 3 (the last two in the dense-top form too),
and in its dense-top form with 64 resident rows a block instead of 128, at
one and at two blocks an SM, with its walk taking 16 trees a thread at
once instead of 8, and with the walk's loop over 4-feature steps unrolled
1 or 4 times instead of 2. The script swaps each variant into the port's
wrapper and times it against the committed build at the same shapes (the
path kernels on the mammography models and the same 1,000,000 rows; the
dense-table kernel on seeded F = k = 274 forests of heights 7, 8 and 10
and 65,536 rows, and on the forest and 2^19 rows the benchmark's
``arrhythmia-eif`` configuration makes from a seed, ``portbench/inputs.py``).
The dense-table kernel's form is timed without an edit: at every height
from 3 to 10 and on that cell's inputs, each dense-top depth it has and its
fully dense form against the form the wrapper picks
(``ops/ext_dense.py::dense_top_levels``). ``--dense-table`` runs only the
dense-table kernel's measurements. The record layout is timed the same way with
another table: the EIF path kernels' records with two terms and their i32
feature indices to a chunk instead of three with 10-bit ones. Every
variant must give the committed build's result bit for bit. Times are
CUDA-event medians, taken in turns (committed, variant, variant,
committed). The small-batch switch point of the path kernels: each
kernel's bulk launch (a thread a row) against its small-batch launch (a
warp a row), in turns and bitwise equal, on the first 1 to 262,144 of the
rows.

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
import shutil
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

VARIANT_DIR = ROOT / "build" / "kernel_paths"
OLD_TREE = VARIANT_DIR / "old"
OLD_SOURCES = ("walk", "ext_walk")
STD_MODEL = ROOT / "tests" / "resources" / "torch_port" / "mammography_std" / "model"
EIF_MODEL = ROOT / "tests" / "resources" / "torch_port" / "mammography_eif" / "model"
MAMMOGRAPHY = ROOT / "tests" / "resources" / "mammography.csv"
ROWS, HIGH_DIM_ROWS, SEED = 1_000_000, 65_536, 0

# the dense-table kernel's choice of column-tile width in its fully dense
# form, and its dense-top form's rows a block
GEMM_TILES = "return m4 > 128 ? launch<4, 0>"
PATH_ROWS = "constexpr int kPathRows = 128;"
WALK_UNROLL = "#pragma unroll 2\n        for (int f = 0; f < w4; f += 4) {"
# the path kernels of csrc/path_walk.cu, at the main path's shape
EIF_PATH_CALLS = ("ext_walk_sum", "ext_sparse_mean")
PATH_CALLS = ("walk_sum",) + EIF_PATH_CALLS
# rows of the small-batch switch measurement
SWITCH_ROWS = (1, 64, 1024, 4096, 16384, 65536, 98304, 131072, 262144)
# the dense-table kernel at every height the tool times it, in the form the
# wrapper picks, and in its fully dense form
GEMM_HEIGHTS = ("ext_dense_mean_h7", "ext_dense_mean", "ext_dense_mean_h10", "ext_dense_mean_cell")
GEMM_DENSE_HEIGHTS = ("ext_dense_mean_dense_h7", "ext_dense_mean_dense_h8", "ext_dense_mean_dense_h10")
# heights at which every dense-top depth is timed against the committed one
TOP_HEIGHTS = (3, 4, 5, 6, 7, 8, 9, 10)
# the benchmark's cell arrhythmia-eif.staged-1m: its forest and one chunk of
# its rows, from a seed
CELL, CELL_SEED, CELL_ROWS = "arrhythmia-eif", 2147483701, 1 << 19

# The bulk path kernel's walk of one row a thread, and the same walk of two
# rows a thread, interleaved level by level (a finished row steps on as a
# copy of record 0 and keeps its leaf), in a tile of twice the rows.
ONE_ROW_WALK = """    const long long row = base + threadIdx.x;
    if (row >= n) continue;
    const float* xr = X + row * f_count;
    const float* xs = x_s + threadIdx.x;
    const auto x_at = [&](int f) {
      if constexpr (kSmemX) {
        return xs[f * kTileRows];
      } else {
        return xr[f];
      }
    };
    float acc = 0.f;
    for (int t = 0; t < F.t_count; ++t) {
      int code = F.roots[t];
      while (code < 0) code = step<kTerms>(F, ~code, x_at);
      add_tree<kMean>(acc, __int_as_float(code), t_real);
    }
    out[row] = acc;
"""
TWO_ROW_WALK = """    const long long row0 = base + threadIdx.x, row1 = row0 + kThreads;
    if (row0 >= n) continue;
    const bool two = row1 < n;
    const float* xr0 = X + row0 * f_count;
    const float* xr1 = X + (two ? row1 : row0) * f_count;
    const float* xs0 = x_s + threadIdx.x;
    const float* xs1 = xs0 + kThreads;
    const auto x0 = [&](int f) {
      if constexpr (kSmemX) {
        return xs0[f * kTileRows];
      } else {
        return xr0[f];
      }
    };
    const auto x1 = [&](int f) {
      if constexpr (kSmemX) {
        return xs1[f * kTileRows];
      } else {
        return xr1[f];
      }
    };
    float acc0 = 0.f, acc1 = 0.f;
    for (int t = 0; t < F.t_count; ++t) {
      int c0 = F.roots[t], c1 = two ? c0 : 0;
      while (c0 < 0 || c1 < 0) {
        const int n0 = step<kTerms>(F, c0 < 0 ? ~c0 : 0, x0);
        const int n1 = step<kTerms>(F, c1 < 0 ? ~c1 : 0, x1);
        c0 = c0 < 0 ? n0 : c0;
        c1 = c1 < 0 ? n1 : c1;
      }
      add_tree<kMean>(acc0, __int_as_float(c0), t_real);
      add_tree<kMean>(acc1, __int_as_float(c1), t_real);
    }
    out[row0] = acc0;
    if (two) out[row1] = acc1;
"""

# The standard walk's bulk launch: the staged kernel where it fits, else the
# core's bulk kernel through __ldg.
THROUGH_LDG = ("else if (small || !launch_staged(x, n, f, F, r, o, s))", "else")

# variant -> (library, calls it is timed on, [(text in the source, replacement), ...])
VARIANTS = {
    "path_x_through_l1": ("path_walk", EIF_PATH_CALLS, [("  if (f <= kMaxTileFeatures) {\n", "  if (false) {\n")]),
    "path_2_rows_per_thread": ("path_walk", EIF_PATH_CALLS, [
        ("constexpr int kTileRows = kThreads;", "constexpr int kTileRows = 2 * kThreads;"),
        (ONE_ROW_WALK, TWO_ROW_WALK),
    ]),
    "path_records_plain_loads": ("path_walk", EIF_PATH_CALLS, [
        ("const int4 head = __ldg(r);", "const int4 head = r[0];"),
        ("const int4 v = __ldg(r + 1 + c);", "const int4 v = r[1 + c];"),
    ]),
    # the standard walk's bulk batches through the core's kernel (records
    # through __ldg, 128-thread blocks), also with blocks of 256 and 1,024
    # threads; the staged kernel at 512 threads a block, and reading x
    # through L1 instead of staging the row tile
    "walk_records_through_ldg": ("path_walk", ("walk_sum",), [THROUGH_LDG]),
    "walk_ldg_256_threads": ("path_walk", ("walk_sum",), [
        THROUGH_LDG, ("constexpr int kThreads = 128;", "constexpr int kThreads = 256;")]),
    "walk_ldg_1024_threads": ("path_walk", ("walk_sum",), [
        THROUGH_LDG, ("constexpr int kThreads = 128;", "constexpr int kThreads = 1024;")]),
    "walk_staged_512_threads": ("path_walk", ("walk_sum",), [
        ("constexpr int kStageThreads = 1024;", "constexpr int kStageThreads = 512;")]),
    "walk_staged_x_through_l1": ("path_walk", ("walk_sum",), [
        ("for (int i = threadIdx.x; i < kStageThreads * f_count; i += kStageThreads) {",
         "for (int i = threadIdx.x; i < 0; i += kStageThreads) {"),
        ("code = xs[head.w * kStageThreads] >=", "code = X[row * f_count + head.w] >="),
        ("(size_t)r * sizeof(int4) + (size_t)f * kStageThreads * sizeof(float);", "(size_t)r * sizeof(int4);"),
    ]),
    "dense_8_warps": ("dense", ("dense_mean",), [("constexpr int kWarps = 4;", "constexpr int kWarps = 8;")]),
    "dense_rows_loop_unrolled_8": ("dense", ("dense_mean",), [
        ("#pragma unroll\n        for (int j = 0; j < 32; ++j) {", "#pragma unroll 8\n        for (int j = 0; j < rows; ++j) {"),
    ]),
    # the fully dense form: its column-tile widths, registers, chunks and ring
    "gemm_128_slot_tiles": ("ext_gemm", GEMM_DENSE_HEIGHTS, [(GEMM_TILES, "return false ? launch<4, 0>")]),
    "gemm_256_slot_tiles": ("ext_gemm", GEMM_DENSE_HEIGHTS, [(GEMM_TILES, "return true ? launch<4, 0>")]),
    # h = 8 only: at h = 10 its sixth tile ends at slot 1151, past a row's 32 words of bits
    "gemm_192_slot_tiles": ("ext_gemm", ("ext_dense_mean_dense_h8",), [(GEMM_TILES, "return m4 > 128 ? launch<3, 0>")]),
    "gemm_two_blocks_per_sm": ("ext_gemm", ("ext_dense_mean_dense_h8",), [
        ("__launch_bounds__(kThreads, 1)", "__launch_bounds__(kThreads, 2)"),
    ]),
    "gemm_8_feature_chunks": ("ext_gemm", ("ext_dense_mean_dense_h8", "ext_dense_mean"), [
        ("constexpr int kBK = 16;", "constexpr int kBK = 8;"),
    ]),
    "gemm_2_stages": ("ext_gemm", ("ext_dense_mean_dense_h8", "ext_dense_mean"),
                      [("constexpr int kStages = 3;", "constexpr int kStages = 2;")]),
    # the dense-top form: 64 resident rows a block instead of 128 (four
    # threads a row), at one and at two blocks an SM; the walk with 16
    # trees a thread instead of 8 (the resident tile then fits up to 352
    # features), and its loop over 4-feature steps unrolled 1 or 4 times
    # instead of 2
    "gemm_path_64_rows": ("ext_gemm", GEMM_HEIGHTS, [(PATH_ROWS, "constexpr int kPathRows = 64;")]),
    "gemm_path_64_rows_two_blocks": ("ext_gemm", GEMM_HEIGHTS, [
        (PATH_ROWS, "constexpr int kPathRows = 64;"),
        ("__launch_bounds__(kThreads, 1)", "__launch_bounds__(kThreads, 2)"),
    ]),
    "gemm_walk_16_chains": ("ext_gemm", GEMM_HEIGHTS, [
        ("constexpr int kWalkChains = 8;", "constexpr int kWalkChains = 16;"),
        ("constexpr int kPathMaxWidth = 384;", "constexpr int kPathMaxWidth = 352;"),
    ]),
    "gemm_walk_unroll_1": ("ext_gemm", GEMM_HEIGHTS, [(WALK_UNROLL, WALK_UNROLL.replace("unroll 2", "unroll 1"))]),
    "gemm_walk_unroll_4": ("ext_gemm", GEMM_HEIGHTS, [(WALK_UNROLL, WALK_UNROLL.replace("unroll 2", "unroll 4"))]),
}

def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def extract_old(rev: str) -> None:
    """The package and ``chip_smoke.py`` at git revision ``rev`` into ``OLD_TREE``."""
    shutil.rmtree(OLD_TREE, ignore_errors=True)
    OLD_TREE.mkdir(parents=True)
    archive = subprocess.run(["git", "archive", rev, "isoforest_tpu_torch", "chip_smoke.py"], cwd=ROOT,
                             capture_output=True, check=True).stdout
    subprocess.run(["tar", "-x", "-C", str(OLD_TREE)], input=archive, check=True)
    (OLD_TREE / "REVISION").write_text(rev + "\n")


SERVING = """
import json, sys
import numpy as np
root, std, eif, csv = sys.argv[1:5]
sys.path.insert(0, root)
from chip_smoke import serving_latency
from isoforest_tpu_torch import load_model
X = np.loadtxt(csv, delimiter=",", comments="#").astype(np.float32)[:, :-1]
X = np.ascontiguousarray(X[np.random.default_rng(0).integers(0, len(X), 4096)])
print(json.dumps({name: serving_latency(load_model(path), X, ("auto", "dense"))
                  for name, path in (("std", std), ("eif", eif))}))
"""


def serving_in_turns(rounds: int = 3) -> None:
    """Serving latency of the old tree and of this one, in turns (old, new,
    new, old, then new, old, old, new, ...), each in a process of its own,
    then every (model, strategy, batch)'s medians side by side."""
    runs = {"old": [], "new": []}
    for r in range(rounds):
        order = ("old", "new", "new", "old") if r % 2 == 0 else ("new", "old", "old", "new")
        for which in order:
            root = OLD_TREE if which == "old" else ROOT
            out = subprocess.run([sys.executable, "-c", SERVING, str(root), str(STD_MODEL), str(EIF_MODEL),
                                  str(MAMMOGRAPHY)], capture_output=True, text=True, check=True, timeout=600)
            latency = json.loads(out.stdout.strip().splitlines()[-1])
            runs[which].append(latency)
            emit({"serving": which, "latency": latency})
    emit({"serving_medians_ms": {
        f"{model}_{key}": {which: [run[model][key]["median_ms"] for run in runs[which]] for which in runs}
        for model in runs["old"][0] for key in runs["old"][0][model]}})


def build_variants(dense_table_only: bool = False) -> dict:
    """``{variant: path}`` of the libraries (the edited variants and the
    earlier designs, ``old_walk`` and ``old_ext_walk``; only the
    dense-table kernel's variants when ``dense_table_only``), all nvcc
    started together. A variant that does not build is reported and left
    out; an earlier design that does not build stops the run."""
    from isoforest_tpu_torch.ops import _build

    VARIANT_DIR.mkdir(parents=True, exist_ok=True)
    sources = {}
    for variant, (name, _, edits) in VARIANTS.items():
        if dense_table_only and name != "ext_gemm":
            continue
        edited = (_build.CSRC_DIR / _build.SOURCES[name]).read_text()
        for old, new in edits:
            if edited.count(old) != 1:
                raise SystemExit(f"{_build.SOURCES[name]}: the text to edit for {variant} is not there once: {old!r}")
            edited = edited.replace(old, new)
        src = VARIANT_DIR / f"{name}-{variant}.cu"
        src.write_text(edited)
        sources[variant] = src
    for name in () if dense_table_only else OLD_SOURCES:
        src = OLD_TREE / "isoforest_tpu_torch" / "csrc" / f"{name}.cu"
        if not src.is_file():
            raise SystemExit(f"{src} is missing: run with --extract-old REV where git is first")
        sources[f"old_{name}"] = src
    procs = {}
    for variant, src in sources.items():
        lib = VARIANT_DIR / f"lib{variant}.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)]
        procs[variant] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for key, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode == 0:
            libs[key] = lib
        elif key in VARIANTS:
            emit({"variant": key, "build_failed": log[-4000:]})
        else:
            raise SystemExit(f"nvcc failed for {key}:\n{log}")
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


def in_turns(first: str, first_call, second: str, second_call, reps: int) -> dict:
    """Results and CUDA-event times of two calls, in turns (first, second,
    second, first); raises unless the results are equal bit for bit."""
    import torch

    runs, outputs = {first: [], second: []}, {}
    for which, call in ((first, first_call), (second, second_call), (second, second_call), (first, first_call)):
        outputs[which] = call()
        runs[which].append(time_ms(call, reps))
    equal = bool(torch.equal(outputs[first], outputs[second]))
    if not equal:
        raise SystemExit(f"{first} and {second} differ: {float((outputs[first] - outputs[second]).abs().max())}")
    return {"bitwise_equal": equal, f"{first}_ms": runs[first], f"{second}_ms": runs[second],
            f"{second}_over_{first}": statistics.mean(runs[second]) / statistics.mean(runs[first])}


def kernel_calls(X_big, std_model, eif_model) -> dict:
    """``{call: (call, signatures, reps, shape)}`` at the main path's shapes
    (the dense-table kernel also at heights 7 and 10 besides its cell's 8,
    the EIF path kernels also on records with i32 indices), then the path
    kernels' rows on the card and ``{path kernel: its records}``."""
    import numpy as np
    import torch

    from isoforest_tpu_torch.io.interop import extended_forest_from_arrays
    from isoforest_tpu_torch.ops import dense, ext_dense, ext_path, ext_walk, walk
    from isoforest_tpu_torch.testing import random_extended_forest, rows

    dev = torch.device("cuda")
    Xd = torch.from_numpy(X_big).to(dev)
    std_tables = dense.pack_standard(std_model.forest)
    std_wt = walk.walk_tables(std_model.forest)
    wt = ext_walk.walk_tables_extended(eif_model.forest)
    st = ext_dense.sparse_path_records(eif_model.forest)
    rng = np.random.default_rng(SEED + 1)
    f5 = extended_forest_from_arrays(*random_extended_forest(rng, 100, 8, 274, 274, split_p=1.0))
    X5 = torch.from_numpy(rows(rng, HIGH_DIM_ROWS, 274)).to(dev)
    dt = ext_dense.dense_hyperplane_table(f5)
    rows_shape = {"rows": ROWS}
    calls = {
        "dense_mean": (lambda: dense.dense_mean(Xd, std_tables), dense._SIGNATURES, 7, rows_shape),
        "ext_dense_mean": (lambda: ext_dense.ext_dense_mean(X5, dt), ext_dense._DENSE_SIGNATURES, 3,
                           {"rows": HIGH_DIM_ROWS, "features": 274, "height": 8}),
        "walk_sum": (lambda: walk.walk_sum(Xd, std_wt), ext_path.SIGNATURES, 9, rows_shape),
        "ext_walk_sum": (lambda: ext_walk.ext_walk_sum(Xd, wt), ext_path.SIGNATURES, 9, rows_shape),
        "ext_sparse_mean": (lambda: ext_dense.ext_sparse_mean(Xd, st), ext_path.SIGNATURES, 9, rows_shape),
    }
    wide_wt, wide_st = with_i32_indices(wt), with_i32_indices(st)
    calls["ext_walk_sum_i32"] = (lambda: ext_walk.ext_walk_sum(Xd, wide_wt), ext_path.SIGNATURES, 9, rows_shape)
    calls["ext_sparse_mean_i32"] = (lambda: ext_dense.ext_sparse_mean(Xd, wide_st), ext_path.SIGNATURES, 9,
                                    rows_shape)
    gemm_tables = {8: dt}
    for height in TOP_HEIGHTS:
        if height not in gemm_tables:
            gemm_tables[height] = ext_dense.dense_hyperplane_table(
                extended_forest_from_arrays(*random_extended_forest(rng, 100, height, 274, 274, split_p=1.0)))
    for height, table in sorted(gemm_tables.items()):
        shape = {"rows": HIGH_DIM_ROWS, "features": 274, "height": height}
        gemm = (lambda table=table: ext_dense.ext_dense_mean(X5, table), ext_dense._DENSE_SIGNATURES, 3, shape)
        calls[f"ext_dense_mean_sweep_h{height}"] = gemm
        if height in (7, 10):
            calls[f"ext_dense_mean_h{height}"] = gemm
        if height in (7, 8, 10):
            calls[f"ext_dense_mean_dense_h{height}"] = (with_top(height, gemm[0]), ext_dense._DENSE_SIGNATURES, 3,
                                                        {**shape, "top": height})
    cell_forest, X_cell = cell_inputs(dev)
    cell_table = ext_dense.dense_hyperplane_table(cell_forest)
    calls["ext_dense_mean_cell"] = (lambda: ext_dense.ext_dense_mean(X_cell, cell_table), ext_dense._DENSE_SIGNATURES,
                                    3, {"rows": CELL_ROWS, "features": X_cell.shape[1], "height": cell_forest.height,
                                        "forest": f"{CELL} seed {CELL_SEED}"})
    return calls, Xd, {"walk_sum": std_wt, "ext_walk_sum": wt, "ext_sparse_mean": st}


def cell_inputs(device):
    """The forest and ``CELL_ROWS`` scored rows of the benchmark's
    configuration ``CELL`` at seed ``CELL_SEED``, as ``portbench/inputs.py``
    makes them, on ``device``."""
    from isoforest_tpu_torch.io.interop import extended_forest_from_arrays
    from portbench import inputs, spec

    config = spec.load_json(ROOT / "portbench" / "configs" / f"{CELL}.json")
    arrays = inputs.grow_forest(config, seed=CELL_SEED, device=device)
    forest = extended_forest_from_arrays(arrays["indices"], arrays["weights"], arrays["offset"],
                                         arrays["num_instances"], device=device)
    return forest, inputs.scored_rows(config, CELL_ROWS, seed=CELL_SEED, device=device, place="device")


def with_top(top: int, call):
    """``call`` with the dense-table kernel's form forced to ``top``
    dense levels (``top`` = the height: the fully dense form)."""
    from isoforest_tpu_torch.ops import ext_dense

    def run():
        chosen = ext_dense.dense_top_levels
        ext_dense.dense_top_levels = lambda height, width: top
        try:
            return call()
        finally:
            ext_dense.dense_top_levels = chosen

    return run


def compare_top_levels(calls) -> None:
    """The dense-table kernel at each height of ``TOP_HEIGHTS`` and on the
    benchmark cell's forest and rows, with every dense-top depth it has,
    and in its fully dense form, each against the form the wrapper picks,
    in turns, bitwise equal."""
    from isoforest_tpu_torch.ops import ext_dense

    for name in (*(f"ext_dense_mean_sweep_h{h}" for h in TOP_HEIGHTS), "ext_dense_mean_cell"):
        call, _, reps, shape = calls[name]
        height = shape["height"]
        committed = ext_dense.dense_top_levels(height, shape["features"])
        for top in (height, *(t for t in ext_dense.DENSE_TOPS if t < height)):
            if top != committed:
                emit({"kernel": "ext_dense_mean", **shape, "committed_top": committed, "variant_top": top,
                      **in_turns("committed", call, "variant", with_top(top, call), reps)})


def with_i32_indices(p):
    """Path records ``p`` with two terms and their i32 feature indices to a
    chunk instead of three with 10-bit ones."""
    import torch

    from isoforest_tpu_torch.ops import ext_path

    fields = [a.cpu().numpy() for a in ext_path.record_fields(p)]
    records = ext_path.pack_records(*fields, chunk_terms=2)
    return p._replace(records=torch.from_numpy(records).to(p.records.device), chunk_terms=2)


def old_walk_tables(forest):
    """The earlier standard walk's heap tables: threshold (+inf off internal
    slots), feature (clamped to >= 0), leaf LUT."""
    import torch

    from isoforest_tpu_torch.ops.scoring_layout import leaf_lut

    internal = forest.feature >= 0
    thr = torch.where(internal, forest.threshold, torch.tensor(float("inf"), device=forest.device))
    leaf = leaf_lut(forest.num_instances, forest.max_nodes).to(forest.device)
    return [a.contiguous() for a in (thr.float(), forest.feature.clamp(min=0).int(), leaf.float())]


def with_lib(name: str, lib, call):
    """``call`` with library ``name`` of the port's wrappers swapped for ``lib``."""
    from isoforest_tpu_torch.ops import _build

    def run():
        _build._LIBS[name] = lib
        return call()

    return run


def compare_designs(libs, calls, Xd, std_model, tables) -> None:
    """Each path kernel against its earlier design: the standard walk
    against the old tree's ``csrc/walk.cu`` on heap tables, the two EIF path
    kernels against the old tree's ``csrc/ext_walk.cu`` on the same records
    (its entries took no record count)."""
    import torch

    from isoforest_tpu_torch.ops import _build

    n, f = Xd.shape
    stream = torch.cuda.current_stream().cuda_stream
    P, I = ctypes.c_void_p, ctypes.c_int
    thr, feat, leaf = old_walk_tables(std_model.forest)
    old_walk = load_variant(libs["old_walk"], {"walk_sum": (P, I, I, P, P, P, I, I, P, P)})
    old_ext = load_variant(libs["old_ext_walk"], {name: (P, I, I, P, P, I, I, I, I, P, P) for name in EIF_PATH_CALLS})

    def old_walk_call():
        out = torch.empty(n, dtype=torch.float32, device=Xd.device)
        _build.check(old_walk.walk_sum(Xd.data_ptr(), n, f, thr.data_ptr(), feat.data_ptr(), leaf.data_ptr(),
                                       thr.shape[0], std_model.forest.height, out.data_ptr(), stream),
                     "earlier walk_sum")
        return out

    def old_ext_call(name):
        p = tables[name]

        def run():
            out = torch.empty(n, dtype=torch.float32, device=Xd.device)
            _build.check(getattr(old_ext, name)(Xd.data_ptr(), n, f, p.records.data_ptr(), p.roots.data_ptr(),
                                                p.num_trees, p.k, p.chunk_terms, 0, out.data_ptr(), stream),
                         f"earlier {name}")
            return out

        return run

    for name, old_call in (("walk_sum", old_walk_call), *((name, old_ext_call(name)) for name in EIF_PATH_CALLS)):
        call, _, reps, _ = calls[name]
        emit({"kernel": name, "rows": n, **in_turns("old", old_call, "new", call, reps)})


def compare_layouts(calls) -> None:
    """The path kernels on records with i32 indices against the committed
    narrowest type, with the committed build."""
    for name in EIF_PATH_CALLS:
        call, _, reps, shape = calls[name]
        emit({"kernel": name, "variant": "path_records_i32_indices", **shape,
              **in_turns("committed", call, "variant", calls[f"{name}_i32"][0], reps)})


def switch_point(Xd, tables) -> None:
    """Each path kernel's bulk launch against its small-batch launch on the
    first ``SWITCH_ROWS`` rows, in turns, bitwise equal."""
    from isoforest_tpu_torch.ops import ext_path

    for n in SWITCH_ROWS:
        x = Xd[:n].contiguous()
        for name in PATH_CALLS:
            p = tables[name]
            result = in_turns("bulk", lambda: ext_path.launch(name, x, p, tree_parallel=False),
                              "small", lambda: ext_path.launch(name, x, p, tree_parallel=True), reps=9)
            emit({"kernel": name, "switch_rows": n, "committed_switch": ext_path.TREE_PARALLEL_MAX_ROWS[name],
                  **result})


def compare_paths(libs, calls) -> None:
    """Each variant against the committed build of its source."""
    from isoforest_tpu_torch.ops import _build

    for variant, (name, call_names, _) in VARIANTS.items():
        if variant not in libs:
            continue
        for call_name in call_names:
            call, signatures, reps, shape = calls[call_name]
            committed = load_variant(_build.library_path(name), signatures)
            lib = load_variant(libs[variant], signatures)
            result = in_turns("committed", with_lib(name, committed, call), "variant", with_lib(name, lib, call),
                              reps)
            _build._LIBS[name] = committed
            emit({"kernel": "ext_dense_mean" if name == "ext_gemm" else call_name, "call": call_name,
                  "variant": variant, **shape, **result})


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
    if len(sys.argv) == 3 and sys.argv[1] == "--extract-old":
        extract_old(sys.argv[2])
        return 0
    dense_table_only = sys.argv[1:] == ["--dense-table"]
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_port_kernel_paths: no CUDA device is available", file=sys.stderr)
        return 2
    from isoforest_tpu_torch import load_model
    from isoforest_tpu_torch.ops import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    libs = build_variants(dense_table_only)
    emit({"phase": "build_variants", "wall_s": time.perf_counter() - t0, "variants": len(libs)})
    data = np.loadtxt(MAMMOGRAPHY, delimiter=",", comments="#").astype(np.float32)
    X_m = data[:, :-1]
    rng = np.random.default_rng(SEED)
    idx = rng.integers(0, len(X_m), ROWS)
    jitter = rng.normal(0.0, 0.01, (ROWS, X_m.shape[1])).astype(np.float32)
    X_big = (X_m[idx] + jitter * X_m.std(axis=0)).astype(np.float32)
    std_model, eif_model = load_model(str(STD_MODEL)), load_model(str(EIF_MODEL))
    if not dense_table_only:
        trace_copies(X_big, std_model, eif_model)
    _build.build()
    calls, Xd, tables = kernel_calls(X_big, std_model, eif_model)
    compare_top_levels(calls)
    compare_paths(libs, calls)
    if not dense_table_only:
        compare_designs(libs, calls, Xd, std_model, tables)
        compare_layouts(calls)
        switch_point(Xd, tables)
        serving_in_turns()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
