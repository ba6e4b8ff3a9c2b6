"""Phase 33 of ``chip_smoke.py`` (the multi-tenant fleet and the overload autopilot) alone, on one card.

Builds the port's kernels and runs ``chip_smoke.fleet_phases`` on the rows
``chip_smoke.main`` makes (``chip_smoke.run_alone``): its checks, its
JSON line and its timings, in a minute or two instead of the whole smoke's
twelve. Run from the root of a checkout on a machine with a CUDA card:

    python3 tools/torch_port_fleet_phase.py
"""

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    sys.exit(chip_smoke.run_alone("fleet"))
