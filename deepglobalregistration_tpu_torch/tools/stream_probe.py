"""register_many's window against the register() loop and register_batch.

Counterpart of the JAX package's ``tools/stream_probe.py``, which times the
pipelined ``register_many`` against the sequential loop. At ``bench.py``'s
configuration (``tools/batch_bench.BENCH``: ResUNetBN2C FCGF with the
committed weights, bf16 convs, 5 cm voxel) on ``bench.py``'s stream of
``--pairs`` pairs ``synthetic_pair(n=--points, seed=i % 4)``, after one
warm-up call of each form, ``--turns`` turns run every form (the order
reversed on every other turn):

- ``loop``: ``register()`` pair by pair;
- ``window W`` for each W of ``--windows``: ``register_many(window=W)``;
- ``batch``: ``register_batch(force_vmapped=True)``.

Then one more call of each form runs under ``utils/profiling.trace``. One
JSON line a form gives the median s/pair over the turns with the turns'
own values, the peak device memory, the 1-NN launches of a turn, and from
the profiled call the kernels' summed device time, the time in which at
least one kernel ran (kernels on several streams overlap) and that time's
share of the profiled wall time (the busy share).

    python -m deepglobalregistration_tpu_torch.tools.stream_probe [--turns 3]
        [--pairs 8] [--points 30000] [--windows 1,2,3,4] [--device cuda]

Times are host clock between device synchronisations. ``--device cpu`` runs
the plain versions: its times are the CPU's and its device fields are None.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import tempfile
import time

import numpy as np
import torch

from ..config import default_config
from ..core.pipeline import DeepGlobalRegistration
from ..utils import profiling
from ..utils.synthetic import synthetic_pair
from .batch_bench import BENCH, _sync, run_turn


def _forms(windows):
    return [("loop", None)] + [("many", w) for w in windows] + [("batch", None)]


def _label(kind: str, window) -> str:
    return f"window {window}" if kind == "many" else kind


def _busy(dgr, kind: str, window, xyz0s, xyz1s) -> dict:
    """One call of the form under the profiler: its wall time, the kernels'
    summed and union device ms and the union's share of the wall time."""
    if dgr.device.type != "cuda":
        return {"profiled_wall_s": None, "kernel_ms_sum": None,
                "kernel_ms_busy": None, "busy_share": None}
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace(tmp, with_stack=False):
            _sync(dgr)
            t0 = time.perf_counter()
            run_turn(dgr, kind, xyz0s, xyz1s, window)
            wall = time.perf_counter() - t0
        total, _ = profiling.kernel_totals(tmp)
        busy = profiling.kernel_busy_ms(tmp)
    return {"profiled_wall_s": wall, "kernel_ms_sum": total, "kernel_ms_busy": busy,
            "busy_share": busy / (wall * 1e3)}


def probe(dgr, xyz0s, xyz1s, windows=(1, 2, 3, 4), turns: int = 3) -> list:
    """The forms in turns on one instance; returns one dict a form."""
    forms = _forms(windows)
    for kind, w in forms:  # warm-up
        run_turn(dgr, kind, xyz0s, xyz1s, w)
    runs = {_label(k, w): [] for k, w in forms}
    for t in range(turns):
        for kind, w in (forms if t % 2 == 0 else forms[::-1]):
            runs[_label(kind, w)].append(run_turn(dgr, kind, xyz0s, xyz1s, w))
    out = []
    for kind, w in forms:
        rs = runs[_label(kind, w)]
        s = [r["s_per_pair"] for r in rs]
        peaks = [r["peak_mem_gib"] for r in rs]
        out.append({"form": _label(kind, w), "pairs": len(xyz0s), "turns": len(rs),
                    "s_per_pair_median": float(np.median(s)), "s_per_pair_turns": s,
                    "peak_mem_gib": None if None in peaks else max(peaks),
                    "launches": rs[-1]["launches"],
                    **_busy(dgr, kind, w, xyz0s, xyz1s)})
    return out


def card() -> str | None:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError):
        return None


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--pairs", type=int, default=8)
    ap.add_argument("--points", type=int, default=30000)
    ap.add_argument("--windows", default="1,2,3,4")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dgr = DeepGlobalRegistration(default_config(**BENCH), device=args.device)
    pairs = [synthetic_pair(n=args.points, seed=s) for s in range(min(args.pairs, 4))]
    stream = [pairs[i % len(pairs)] for i in range(args.pairs)]
    windows = [int(w) for w in args.windows.split(",")]
    rows = probe(dgr, [p[0] for p in stream], [p[1] for p in stream], windows,
                 args.turns)
    kind = (torch.cuda.get_device_name(dgr.device) if dgr.device.type == "cuda"
            else "cpu (plain versions)")
    for r in rows:
        print(json.dumps({"device": kind, "card": card(), **r}), flush=True)
    return rows


if __name__ == "__main__":
    main()
