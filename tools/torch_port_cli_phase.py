"""Phase 36 of ``chip_smoke.py`` (the command line and ONNX export) alone, on one card.

Builds the port's kernels and runs ``chip_smoke.cli_phases`` on the rows
``chip_smoke.main`` makes (``chip_smoke.run_alone``): its checks, its JSON
line and its timings, without the rest of the smoke. It starts five
``python -m isoforest_tpu_torch`` processes on the card. Run from the root
of a checkout on a machine with a CUDA card:

    python3 tools/torch_port_cli_phase.py
"""

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    sys.exit(chip_smoke.run_alone("cli"))
