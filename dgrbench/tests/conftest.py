"""Tests of the benchmark itself. ``pytest dgrbench/tests`` runs the CPU ones
here; the tests marked ``card`` need a CUDA card and skip without one; on a
machine with one: ``pytest dgrbench/tests -m card``."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (decided inside the test); skips without one")
