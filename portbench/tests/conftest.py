"""Tests of the benchmark itself, on the CPU: ``python -m pytest
portbench/tests -q`` from the repository root. Tests marked ``card`` need
an H100 and skip elsewhere, deciding so inside the test."""

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (an H100); skips without one")
