"""One run of one cell: set-up, the measured window, the comparison with
the reference, the per-layer readers, and the result line.

The result line is the last line of standard output, one JSON object with
``correct``, ``attempted``, ``failed``, ``metrics``, ``device`` and, traced,
``breakdown``; ``info`` records what the run resolved (strategy, launches,
the card's power limit), and ``checks``, last,
every number compared with its limit, as the last lines of standard error
do too.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time
from typing import Optional

from . import check, spec
from . import loops

JAX_NAMES = frozenset({"jax", "jaxlib", "flax", "isoforest_tpu"})


class NoCard(SystemExit):
    """The cell needs more cards than this machine has: no result."""


def jax_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: ``isoforest_tpu_torch`` is neither)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & JAX_NAMES)


def _launch_counts() -> dict:
    from isoforest_tpu_torch.ops import dense, ext_dense, ext_path

    return {**ext_path.launches, "dense_mean": dense.dense_mean.launches,
            "ext_dense_mean": ext_dense.ext_dense_mean.launches}


def _power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def set_up(cell: spec.Cell, seed: int, device):
    """Set-up of a run: every kernel built (a no-op but in a checkout's
    first run, so that the autotuner's probes time kernels and never a
    build), the inputs from the seed, the model, and the cell's shapes
    warmed through its traffic loop. Returns ``(forest, loop, info)``;
    ``info["built_s"]`` names what this run built with ``nvcc``."""
    import torch

    from isoforest_tpu_torch.telemetry import spans as program_spans
    from isoforest_tpu_torch.tuning import table_snapshot

    from .inputs import build_model, grow_forest

    cuda = device.type == "cuda"
    info = {}
    if cuda:
        from isoforest_tpu_torch.ops import _build

        # seconds of each library nvcc built in this run (in a checkout's
        # first run only; its setup_s holds them)
        info["built_s"] = {name: r["seconds"] for name, r in _build.build().items()}
    forest = grow_forest(cell.config, seed=seed, device=device)
    model = build_model(cell.config, forest, device)
    loop = loops.load(cell.mix["loop"])(model, cell.config, cell.mix, seed, device)
    info["warm"] = loop.warm()
    if cuda:
        torch.cuda.synchronize()
    last = program_spans.records("score_matrix")
    if last:
        info["strategy"] = last[-1].attrs.get("strategy")
        info["strategy_source"] = last[-1].attrs.get("strategy_source")
    info["autotune"] = {key: [e.get("strategy"), e.get("timings_s")]
                        for key, e in table_snapshot().get("entries", {}).items()}
    return forest, loop, info


def run(workload: str, seed: int, seconds: float, trace: bool, *, t_start: float, device=None,
        require_card: bool = True, overrides: Optional[dict] = None) -> dict:
    """Run the cell ``workload`` once and return its result object.
    ``require_card=False`` (the tests) skips the look for a card and runs
    on ``device``."""
    import torch

    from .inputs import forest_tensors
    from .reference import peaks as ref_peaks
    from .reference import score as ref_score

    cell = spec.load_cell(workload, overrides)
    if require_card:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            raise NoCard(f"{workload} needs {cell.chips} CUDA device(s); "
                         f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        device = torch.device("cuda", 0)
    device = torch.device(device)
    cuda = device.type == "cuda"
    config = cell.config

    forest, loop, info = set_up(cell, seed, device)
    launches_before = _launch_counts()

    # -- the measured window
    prof = collector = None
    ctx = {}
    if trace:
        from . import trace as tr

        collector = tr.SpanCollector().start()
        ctx["counters_before"] = tr.counters()
        if cuda:
            prof = tr.device_profiler()
            prof.__enter__()
    gc.collect()
    setup_s = time.perf_counter() - t_start
    win = loop.window(seconds)
    if trace:
        if prof is not None:
            prof.__exit__(None, None, None)
        ctx["spans"] = collector.stop()
        ctx["counters_after"] = tr.counters()
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    launches = {k: v - launches_before[k] for k, v in _launch_counts().items() if v - launches_before[k]}
    answered = max(sum(win.served.values()), 1)
    info.update(win.info)
    info["launches_per_answer"] = {k: v / answered for k, v in launches.items()}

    # -- the reference, once the program's state is freed
    ref_rows = loop.rows
    loop.close()
    del loop
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    forest_t = forest_tensors(forest, device)
    reference = ref_score.score(forest_t, ref_rows, max_samples=int(config["maxSamples"]))
    if any(not (isinstance(a.scores, torch.Tensor) and a.scores.is_cuda) for a in win.answers):
        reference = type(reference)(*(field.cpu() for field in reference))
    numbers = check.compare(win.answers, win.due, reference)
    limits = config["limits"]
    correct = check.judge(numbers, limits)
    info["reference_s"] = time.perf_counter() - t_ref

    metrics = {}
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if not trace:
        values = dict(win.metrics, setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in values}
    out_device = {"platform": "gpu" if cuda else device.type,
                  "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                  "count": cell.chips, "memory_peak_bytes": int(memory_peak)}
    breakdown = None
    if trace:
        visited = reference.visited.cpu().to(torch.float64)
        prefix = torch.cat([torch.zeros(1, dtype=torch.float64), torch.cumsum(visited, 0)])
        ops = nbytes = 0.0
        rows_scored = 0
        for (start, stop), count in win.served.items():
            o, b = ref_score.work(forest_t, stop - start, int(config["numFeatures"]),
                                  float(prefix[stop] - prefix[start]))
            ops, nbytes, rows_scored = ops + o * count, nbytes + b * count, rows_scored + (stop - start) * count
        if prof is not None:
            ctx["device"], ctx["launches"] = tr.read_profile(prof)
        else:
            ctx["device"], ctx["launches"] = [], {}
        ctx.update(w0_ns=win.w0_ns, w1_ns=win.w1_ns, rows_scored=rows_scored, ops=ops, bytes=nbytes,
                   peaks=ref_peaks.peaks_for(out_device["kind"]) if cuda else None)
        busy = tr.busy_ns(ctx["device"], win.w0_ns, win.w1_ns)
        if cuda:
            out_device.update(busy_s=busy / 1e9, window_s=(win.w1_ns - win.w0_ns) / 1e9)
        for m in cell.per_layer:
            value = spec.reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}
        breakdown = {"device_ops": tr.top_device_ops(ctx), "idle_gaps": tr.top_idle_gaps(ctx)}
        kinds = {}
        for i in ctx["device"]:
            kinds[i.kind] = kinds.get(i.kind, 0) + 1
        kernels = [i for i in ctx["device"] if i.kind == "kernel"]
        info["device_events"] = kinds
        info["kernels_tied_to_launch"] = (sum(k.correlation in ctx["launches"] for k in kernels) / len(kernels)
                                          if kernels else None)
        info["least_s"] = ref_peaks.least_seconds(ops, nbytes, ctx["peaks"]) if cuda else None
    if cuda:
        info["card"] = _power_limit()

    result = {"correct": bool(correct), "attempted": int(win.attempted), "failed": int(win.failed),
              "metrics": metrics, "device": out_device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["info"] = info
    result["checks"] = {name: {"value": numbers[name], "limit": limits[name]} for name in limits}
    return result


def main(argv=None, *, t_start: float) -> int:
    parser = argparse.ArgumentParser(description="Run one cell of the benchmark once.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    try:
        result = run(args.workload, args.seed, args.seconds, bool(args.trace), t_start=t_start)
    except NoCard as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 2
    found = jax_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}; no result", file=sys.stderr)
        return 3
    for line in check.lines({k: v["value"] for k, v in result["checks"].items()},
                            {k: v["limit"] for k, v in result["checks"].items()}):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    sys.stdout.flush()
    return 0
