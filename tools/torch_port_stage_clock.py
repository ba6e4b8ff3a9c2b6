"""Where the card's idle time of a traced bulk window falls among the
program's stage marks, and whether the marks and the device trace share a
clock.

One traced window of a benchmark cell, made as ``portbench/harness.py``
makes it (set-up, the span collector, ``torch.profiler`` over the card),
then one JSON line:

* ``idle_in_chunks``: the idle seconds that ``breakdown.idle_gaps`` puts
  under ``...>pipeline.chunk`` (each gap under what the host did at its
  middle), and the share of them inside one of the chunk spans' marked
  stages;
* ``idle_by_stage``: every idle second of the window that falls inside a
  marked stage, by span, stage and chunk index;
* ``clock``: the share of the window's launch records of K5 that fall inside a ``pipeline.chunk`` span's ``launch``
  stage, the offset of such a record from its stage's start and its margin
  to the stage's end (a launch stage lasts under a millisecond, so an offset
  between the profiler's clock and ``time.time_ns()`` larger than those
  margins shows);
* the per-layer metrics of the cell as the benchmark's readers give them.

Run from the root of a checkout on a machine with a CUDA card:

    python3 tools/torch_port_stage_clock.py --workload arrhythmia-eif.staged-1m --seed 7 --seconds 30

``--device cpu`` rehearses it on the CPU at a small size (no device trace:
the idle figures are then empty).
"""

from __future__ import annotations

import argparse
import bisect
import json
import pathlib
import statistics
import sys
import time
from collections import defaultdict

ROOT = pathlib.Path(__file__).resolve().parents[1]

# the CPU rehearsal's size: the benchmark's own small EIF configuration
SMALL = {"mix": {"rows": 2048},
         "config": {"numEstimators": 10, "numFeatures": 6, "extensionLevel": 5,
                    "data": {"generator": "high_dim_blobs", "num_features": 6, "contamination": 0.146}}}


KERNEL = "ext_gemm_kernel"  # K5, the kernel `auto` picks in arrhythmia-eif.staged-1m


def analyse(ctx: dict, kernel: str = KERNEL) -> dict:
    from portbench import spec
    from portbench import trace as tr

    overlap_ns = spec.reader("staging_exposed_ms.bulk").overlap_ns

    w0, w1 = ctx["w0_ns"], ctx["w1_ns"]
    gaps = tr.idle_gaps(ctx["device"], w0, w1) if ctx["device"] else []
    marked = [s for s in ctx["spans"] if s.attrs.get("stages")]
    stages = tr.union([(a, b) for s in marked if s.name == "pipeline.chunk" for _, a, b in s.attrs["stages"]])

    labels = tr.host_activities(ctx["spans"], [(s + e) // 2 for s, e in gaps])
    chunk_gaps = [g for g, what in zip(gaps, labels) if what.endswith("pipeline.chunk")]
    in_chunks = sum(e - s for s, e in chunk_gaps)
    covered = overlap_ns(chunk_gaps, stages)

    by_stage = defaultdict(int)
    for s in marked:
        for name, a, b in s.attrs["stages"]:
            key = f"{s.name}:{name}" + (f":{s.attrs.get('index')}" if s.name == "pipeline.chunk" else "")
            by_stage[key] += overlap_ns(gaps, [(a, b)])

    host_by_stage = defaultdict(list)
    for s in marked:
        if w0 <= s.attrs["stages"][0][1] and s.attrs["stages"][-1][2] <= w1:
            for name, a, b in s.attrs["stages"]:
                key = f"{s.name}:{name}" + (f":{s.attrs.get('index')}" if s.name == "pipeline.chunk" else "")
                host_by_stage[key].append((b - a) / 1e6)

    launch_stages = sorted((a, b) for s in marked if s.name == "pipeline.chunk"
                           for name, a, b in s.attrs["stages"] if name == "launch")
    starts = [a for a, _ in launch_stages]
    records = [ctx["launches"][k.correlation] for k in ctx["device"]
               if k.kind == "kernel" and kernel in k.name and w0 <= k.start_ns < w1 and k.correlation in ctx["launches"]]
    inside, offsets, to_end, misses = 0, [], [], []
    for at in records:
        j = bisect.bisect_right(starts, at) - 1
        if j >= 0 and at <= launch_stages[j][1]:
            inside += 1
            offsets.append((at - launch_stages[j][0]) / 1e3)
            to_end.append((launch_stages[j][1] - at) / 1e3)
        else:
            near = min((abs(at - x) for pair in launch_stages for x in pair), default=None)
            misses.append(None if near is None else near / 1e3)

    return {
        "window_s": (w1 - w0) / 1e9,
        "idle_s": sum(e - s for s, e in gaps) / 1e9,
        "idle_in_chunks": {"idle_s": in_chunks / 1e9, "in_marked_stages_s": covered / 1e9,
                           "share": covered / in_chunks if in_chunks else None},
        "idle_by_stage_s": {k: v / 1e9 for k, v in sorted(by_stage.items(), key=lambda kv: -kv[1])},
        "host_ms_by_stage": {k: {"n": len(v), "median": statistics.median(v), "max": max(v)}
                             for k, v in sorted(host_by_stage.items())},
        "clock": {"kernel": kernel, "launch_records": len(records), "inside_launch_stage": inside,
                  "share": inside / len(records) if records else None,
                  "median_offset_us": statistics.median(offsets) if offsets else None,
                  "offset_us_min_max": [min(offsets), max(offsets)] if offsets else None,
                  "before_stage_end_us_min_median": [min(to_end), statistics.median(to_end)] if to_end else None,
                  "misses_nearest_edge_us": sorted(misses)[:20]},
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", default="arrhythmia-eif.staged-1m")
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, default=30.0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from portbench import spec

    spec.pin_caches()
    import torch

    from portbench import harness
    from portbench import trace as tr

    cuda = args.device == "cuda"
    device = torch.device("cuda", 0) if cuda else torch.device("cpu")
    cell = spec.load_cell(args.workload, None if cuda else SMALL)
    forest, loop, info = harness.set_up(cell, args.seed, device)
    collector = tr.SpanCollector().start()
    prof = tr.device_profiler() if cuda else None
    if prof is not None:
        prof.__enter__()
    win = loop.window(args.seconds)
    if prof is not None:
        prof.__exit__(None, None, None)
    spans = collector.stop()
    device_events, launches = tr.read_profile(prof) if prof is not None else ([], {})
    rows = sum((stop - start) * count for (start, stop), count in win.served.items())
    ctx = {"device": device_events, "launches": launches, "spans": spans, "w0_ns": win.w0_ns,
           "w1_ns": win.w1_ns, "rows_scored": rows}
    line = {"workload": args.workload, "seed": args.seed, "calls": win.info["calls"], "rows_scored": rows,
            "strategy": info.get("strategy"), "card": harness._power_limit() if cuda else None,
            **analyse(ctx),
            "metrics": {name: spec.reader(name).read(ctx)
                        for name in ("staging_exposed_ms.bulk", "dispatch_host_ms.bulk")},
            "idle_gaps": tr.top_idle_gaps(ctx) if device_events else None}
    print(json.dumps(line))
    loop.close()
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(f"stage_clock: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    sys.exit(rc)
