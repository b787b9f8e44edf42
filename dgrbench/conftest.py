"""Small copies of the cells that ``dgrbench/tests/test_dgrbench_control.py``'s
table ``SMALL`` does not list yet.

The control tests build a small copy of every cell in ``BENCHMARK.json``
from that table, keyed by cell: (configuration keys, mix keys) laid over the
cell's own files. A cell added after the table gets its entry here, and the
hook below adds it to the table once the tests are collected, before any
fixture reads it (``pytest dgrbench/tests`` from the root of the repo)."""

import sys

SMALL = {
    # the nets at their published widths, drawn from the seed; short street
    # sweeps, batches of 2 (the process peaks near 11 GB)
    "kitti-train-b8": ({"fcgf_weights": None},
                       {"points": 2500, "scene_points": 5000, "pool_batches": 3,
                        "batch": 2, "trace_calls": 1}),
}


def pytest_collection_modifyitems(items):
    control = sys.modules.get("test_dgrbench_control")
    if control is not None:
        for cell, small in SMALL.items():
            control.SMALL.setdefault(cell, small)
