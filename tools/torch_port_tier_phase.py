"""Phase 35 of ``chip_smoke.py`` (the replicated serving tier) alone, on one card.

Builds the port's kernels and runs ``chip_smoke.tier_phases`` on the rows
``chip_smoke.main`` makes (``chip_smoke.run_alone``): its checks, its JSON
line and its timings, in about a minute and a half instead of the whole
smoke's thirteen. It spawns two replica processes on the card. Run from the
root of a checkout on a machine with a CUDA card:

    python3 tools/torch_port_tier_phase.py
"""

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    sys.exit(chip_smoke.run_alone("tier"))
