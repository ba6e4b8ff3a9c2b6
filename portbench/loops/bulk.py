"""``bulk``: one caller scores the same ``rows`` rows back to back, closed
loop, through ``model.score(X)`` with the user's defaults. The rows stay on
the card (``place: "device"``) or in pageable host memory (``"host"``), in
which case the scores come back to the host. Each call ends in
``torch.cuda.synchronize()``. ``score_rows_per_s`` is every row of the
calls completed in the window over the time from the window's start to the
last completion.

The comparison reads a sample of ``KEEP`` calls drawn from the seed (a
reservoir: uniform over every call of the window). A call that raises ends
the window and is due but never answered.
"""

from __future__ import annotations

import time
from typing import List

import numpy as np

from portbench import inputs as bench_inputs
from portbench.loops import Answer, Window, percentile, sync
from portbench.reference.data import sub_seed

KEEP = 6  # calls the comparison reads
WARM_CALLS = 2  # calls of set-up: the first builds the executor's buffers and autotunes


class Loop:
    def __init__(self, model, config: dict, mix: dict, seed: int, device) -> None:
        self.model = model
        self.device = device
        self.rows = bench_inputs.scored_rows(config, int(mix["rows"]), seed=seed, device=device, place=mix["place"])
        self.host = isinstance(self.rows, np.ndarray)
        self.n = int(mix["rows"])
        self.rng = np.random.default_rng(sub_seed(seed, "keep"))

    def call(self):
        out = self.model.score(self.rows)
        if self.host:
            out = out.cpu()
        sync(self.device)
        return out

    def warm(self) -> dict:
        for _ in range(WARM_CALLS):
            self.call()
        return {}

    def window(self, seconds: float) -> Window:
        kept: List[Answer] = []
        calls = failed = 0
        errors, durations = [], []
        w0_ns, t0 = time.time_ns(), time.perf_counter()
        deadline = t0 + seconds
        last = t0
        while time.perf_counter() < deadline:
            try:
                out = self.call()
            except Exception as exc:  # ends the window; due, never answered
                failed += 1
                errors.append(f"{type(exc).__name__}: {exc}")
                break
            now = time.perf_counter()
            durations.append(now - last)
            last = now
            calls += 1
            if len(kept) < KEEP:
                kept.append(Answer(0, self.n, out))
            else:
                j = int(self.rng.integers(calls))
                if j < KEEP:
                    kept[j] = Answer(0, self.n, out)
        w1_ns = time.time_ns()
        elapsed = max(last - t0, 1e-9)
        return Window(
            attempted=calls + failed, failed=failed,
            metrics={"score_rows_per_s": calls * self.n / elapsed} if calls else {},
            answers=kept, due=min(KEEP, calls) + failed, served={(0, self.n): calls},
            w0_ns=w0_ns, w1_ns=w1_ns,
            info={"calls": calls, "rows_per_call": self.n, "window_s": elapsed, "errors": errors[:3],
                  "call_ms_p10_p50_p90": [percentile(durations, q) * 1e3 for q in (10, 50, 90)] if calls else None},
        )

    def close(self) -> None:
        self.model = None
