"""The traced run's records and the arithmetic the per-layer readers share.

* The device trace: ``torch.profiler`` with CUDA activity only (no host
  operators, so the host's work is not inflated), over the whole window.
  Kernels, copies and memsets become intervals on the host's epoch clock;
  the CUDA runtime's launch records tie each kernel to the host moment it
  was launched.
* The program's spans: a collector thread reads the program's span ring
  (``isoforest_tpu_torch.telemetry.spans.records``) every 20 ms, so that a
  window with more spans than the ring holds loses none.
* The program's counters: the metrics registry before and after the
  window.
"""

from __future__ import annotations

import bisect
import threading
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Tuple

DEVICE_ACTIVITY = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_ACTIVITY = ("cuda_runtime", "cuda_driver")


class Interval(NamedTuple):
    name: str
    kind: str  # one of DEVICE_ACTIVITY
    start_ns: int
    end_ns: int
    correlation: int


class SpanRecord(NamedTuple):
    name: str
    thread: str
    start_ns: int
    end_ns: int
    attrs: dict


class SpanCollector:
    """Polls the program's span ring on a thread of its own."""

    def __init__(self, period_s: float = 0.02) -> None:
        from isoforest_tpu_torch.telemetry import spans

        self._records = spans.records
        self._period_s = period_s
        self._seen: Dict[str, SpanRecord] = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="portbench-spans", daemon=True)

    def _poll(self) -> None:
        for r in self._records():
            if r.span_id not in self._seen:
                start = int(r.start_unix_s * 1e9)
                self._seen[r.span_id] = SpanRecord(r.name, r.thread, start, start + int(r.wall_s * 1e9),
                                                   dict(r.attrs))

    def _run(self) -> None:
        while not self._stop.wait(self._period_s):
            self._poll()

    def start(self) -> "SpanCollector":
        self._poll()
        self._thread.start()
        return self

    def stop(self) -> List[SpanRecord]:
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._poll()
        return sorted(self._seen.values(), key=lambda s: s.start_ns)


def device_profiler():
    """A profiler of the card's activity alone."""
    import torch

    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])


def _kind(event) -> str:
    """An event's activity: kineto's own name where this torch gives it,
    else worked out from the device and the name."""
    activity = getattr(event, "activity_type", None)
    if activity is not None:
        return activity()
    import torch

    if event.device_type() == torch.autograd.DeviceType.CUDA:
        if getattr(event, "is_user_annotation", lambda: False)():
            return "gpu_user_annotation"
        name = event.name()
        return "gpu_memcpy" if name.startswith("Memcpy") else "gpu_memset" if name.startswith("Memset") else "kernel"
    return "cuda_runtime" if event.name().startswith("cuda") else "cuda_driver" if event.name().startswith("cu") \
        else "cpu"


def read_profile(prof) -> Tuple[List[Interval], Dict[int, int]]:
    """``(device intervals, {correlation id: host launch ns})`` of a
    stopped profiler. A device interval carries the correlation id that its
    launch record carries too (the event's own, else its linked one)."""
    device, launches = [], {}
    for e in prof.profiler.kineto_results.events():
        kind = _kind(e)
        if kind in DEVICE_ACTIVITY:
            device.append(e)
        elif kind in LAUNCH_ACTIVITY:
            launches[e.correlation_id()] = e.start_ns()
    intervals = []
    for e in device:
        corr = e.correlation_id()
        if corr not in launches:
            corr = e.linked_correlation_id()
        intervals.append(Interval(e.name(), _kind(e), e.start_ns(), e.start_ns() + e.duration_ns(), corr))
    intervals.sort(key=lambda i: i.start_ns)
    return intervals, launches


def clip(intervals: List[Interval], w0: int, w1: int) -> List[Tuple[int, int]]:
    return [(max(i.start_ns, w0), min(i.end_ns, w1)) for i in intervals if i.end_ns > w0 and i.start_ns < w1]


def union(spans: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_ns(intervals: List[Interval], w0: int, w1: int) -> int:
    """Nanoseconds of the window with any kernel, copy or memset running."""
    return sum(e - s for s, e in union(clip(intervals, w0, w1)))


def idle_gaps(intervals: List[Interval], w0: int, w1: int) -> List[Tuple[int, int]]:
    busy = union(clip(intervals, w0, w1))
    edges = [w0] + [x for s, e in busy for x in (s, e)] + [w1]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]


def host_activities(spans: List[SpanRecord], moments: List[int]) -> List[str]:
    """What the program was doing at each of ``moments``: the spans open
    there, outermost first, or ``outside the program``; one sweep over
    the spans in time order."""
    edges = sorted([(s.start_ns, 1, i) for i, s in enumerate(spans)] + [(s.end_ns, 0, i) for i, s in enumerate(spans)])
    order = sorted(range(len(moments)), key=lambda j: moments[j])
    labels = [""] * len(moments)
    active: Dict[int, SpanRecord] = {}
    e = 0
    for j in order:
        at = moments[j]
        while e < len(edges) and edges[e][0] <= at:  # spans are open on [start, end)
            _, opening, i = edges[e]
            if opening:
                active[i] = spans[i]
            else:
                active.pop(i, None)
            e += 1
        names: List[str] = []
        for s in sorted(active.values(), key=lambda s: (s.start_ns, -s.end_ns)):
            if s.name not in names:
                names.append(s.name)
        labels[j] = ">".join(names) if names else "outside the program"
    return labels


def kernel_ns_in_spans(ctx: dict, span_name: str) -> Optional[int]:
    """Device nanoseconds of the kernels in the window that were launched
    inside a ``span_name`` span; None where no kernel's launch could be tied
    to the host."""
    w0, w1 = ctx["w0_ns"], ctx["w1_ns"]
    inside = union([(s.start_ns, s.end_ns) for s in ctx["spans"] if s.name == span_name])
    kernels = [i for i in ctx["device"] if i.kind == "kernel" and i.end_ns > w0 and i.start_ns < w1]
    if not kernels or not inside:
        return None
    launches = ctx["launches"]
    if not any(k.correlation in launches for k in kernels):
        return None
    starts = [s for s, _ in inside]
    total = 0
    for k in kernels:
        at = launches.get(k.correlation)
        if at is None:
            continue
        j = bisect.bisect_right(starts, at) - 1
        if j >= 0 and at < inside[j][1]:
            total += min(k.end_ns, w1) - max(k.start_ns, w0)
    return total


def top_device_ops(ctx: dict, limit: int = 10) -> List[list]:
    by_name: Dict[str, int] = defaultdict(int)
    for s, e, name in ((max(i.start_ns, ctx["w0_ns"]), min(i.end_ns, ctx["w1_ns"]), i.name) for i in ctx["device"]):
        if e > s:
            by_name[name[:96]] += e - s
    return [[name, ns / 1e9] for name, ns in sorted(by_name.items(), key=lambda kv: -kv[1])[:limit]]


def top_idle_gaps(ctx: dict, limit: int = 10) -> List[list]:
    """Idle seconds of the window summed by what the host was doing at each
    gap's middle, largest first."""
    by_what: Dict[str, int] = defaultdict(int)
    gaps = idle_gaps(ctx["device"], ctx["w0_ns"], ctx["w1_ns"])
    for (s, e), what in zip(gaps, host_activities(ctx["spans"], [(s + e) // 2 for s, e in gaps])):
        by_what[what] += e - s
    return [[what, ns / 1e9] for what, ns in sorted(by_what.items(), key=lambda kv: -kv[1])[:limit]]


# -- the program's counters ---------------------------------------------------


def counters() -> dict:
    """``{(metric, labels): value or (count, sum)}`` of the program's registry."""
    from isoforest_tpu_torch.telemetry.metrics import registry

    out = {}
    for name, snap in registry().snapshot().items():
        for series in snap.get("series", []):
            key = (name, tuple(sorted(series.get("labels", {}).items())))
            out[key] = (series["count"], series["sum"]) if "count" in series else series.get("value", 0.0)
    return out


def delta(ctx: dict, name: str, **labels) -> Tuple[float, float]:
    """``(count, sum)`` of a histogram, or ``(value, value)`` of a counter,
    over the window, summed over the series that carry ``labels``."""
    count = total = 0.0
    for key, after in ctx["counters_after"].items():
        if key[0] != name or any(dict(key[1]).get(k) != str(v) for k, v in labels.items()):
            continue
        before = ctx["counters_before"].get(key, (0, 0.0) if isinstance(after, tuple) else 0.0)
        if isinstance(after, tuple):
            count += after[0] - before[0]
            total += after[1] - before[1]
        else:
            count += after - before
            total += after - before
    return count, total


# -- what the per-layer readers read -------------------------------------------


def roofline_share(ctx: dict) -> Optional[float]:
    """The least time the card could take for the window's scoring work
    (``ctx["ops"]``, ``ctx["bytes"]``: the reference's visited nodes on
    these very rows) over the device time of the kernels launched inside the
    program's ``score_matrix`` spans, in %."""
    from .reference.peaks import least_seconds

    if ctx["peaks"] is None or not ctx["rows_scored"]:
        return None
    ns = kernel_ns_in_spans(ctx, "score_matrix")
    if not ns:
        return None
    return 100.0 * least_seconds(ctx["ops"], ctx["bytes"], ctx["peaks"]) / (ns / 1e9)


def idle_share(ctx: dict) -> Optional[float]:
    """The share of the window with nothing running on the card, in %."""
    if not ctx["device"]:
        return None
    window = ctx["w1_ns"] - ctx["w0_ns"]
    return 100.0 * (1.0 - busy_ns(ctx["device"], ctx["w0_ns"], ctx["w1_ns"]) / window)


def staging_ms_per_mrow(ctx: dict) -> Optional[float]:
    """Host milliseconds the executor spent staging rows (waits on a
    buffer's last copy, packs, enqueues: ``isoforest_pipeline_h2d_seconds``,
    the sum of its ``pipeline.chunk`` spans' ``h2d_s``) per million rows."""
    executions, seconds = delta(ctx, "isoforest_pipeline_h2d_seconds", site="score_matrix")
    if not executions or not ctx["rows_scored"]:
        return None
    return seconds * 1e3 / (ctx["rows_scored"] / 1e6)

