"""Run one cell of the port's benchmark once, on the machine it is started on:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the result line (``portbench/harness.py``) as the last line of
standard output. Exits 2 without a result where the cell's cards are not
there, and 3 where the run loaded JAX or the JAX package.
"""

import time

T_START = time.perf_counter()

import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import spec  # noqa: E402

spec.pin_caches()

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
