"""Phase 32 of ``chip_smoke.py`` (the multi-device layer) alone, on one card.

Builds the port's kernels, makes the rows that ``chip_smoke.main`` makes,
and runs ``chip_smoke.parallel_phases``: its checks, its JSON line and its
timings, in about a minute instead of the whole smoke's ten. Run from the
root of a checkout on a machine with a CUDA card:

    python3 tools/torch_port_parallel_phase.py
"""

import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path.insert(0, str(ROOT))
    t0 = time.perf_counter()
    import numpy as np
    import torch

    import chip_smoke as cs
    from isoforest_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("torch_port_parallel_phase: no CUDA device is available", file=sys.stderr)
        return 2
    _build.build()
    print("build_s", time.perf_counter() - t0, flush=True)
    os.environ["ISOFOREST_TPU_AUTOTUNE_PATH"] = str(ROOT / "build" / f"autotune_{os.getpid()}.json")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    X_m = np.loadtxt(cs.MAMMOGRAPHY, delimiter=",", comments="#").astype(np.float32)[:, :-1]
    # chip_smoke.main's full-size rows
    rng = np.random.default_rng(cs.SEED)
    idx = rng.integers(0, len(X_m), cs.FULL_ROWS)
    jitter = rng.normal(0.0, 0.01, (cs.FULL_ROWS, X_m.shape[1])).astype(np.float32)
    X_big = (X_m[idx] + jitter * X_m.std(axis=0)).astype(np.float32)
    print(cs.parallel_phases(torch.device("cuda"), X_m, X_big, smi))
    print("total_s", time.perf_counter() - t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
