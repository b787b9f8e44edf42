"""The control, and planted faults, at a cell's own size.

The control is the plain reference put in the program's place and computed
in the nearest precision below the configuration's (float32 convs and
geometry: TF32 on); the same judge as a run's then reads its answers in
float32, so it must come out not correct. A fault is planted in the
reference put in the program's place (float32): ``half_batch`` leaves half
of each training batch out and takes the mean over the rest. (A training
state left unchanged reads 1 on ``change_gap`` by its definition.)

    python3 -m dgrbench.control --workload NAME --seeds N [N ...] [--fault half_batch]

prints one JSON line a seed: each number beside the cell's limit, and
whether every number kept to its limit. Imports nothing of the program.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from typing import Dict

import torch

from . import run
from .drivers import common, register_batch, train_step
from .reference import judge
from .traffic import pairs


def _tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def readings(workload: str, seed: int, fault: str | None = None, device: str = "cuda",
             bench: Dict | None = None) -> Dict[str, float]:
    """The judge's numbers for the control (fault None) or a planted fault,
    on the inputs a run of ``workload`` with ``seed`` checks."""
    bench = bench or run.with_held(run.load_json(run.ROOT, "BENCHMARK.json"))
    _, _, config, mix = run.find_cell(bench, workload)
    trees = common.make_trees(config, common.weights_seed(mix, seed), device)
    lower = fault is None
    if mix["driver"] == "register_batch":
        pool = pairs.pool(mix["pool_seed"], mix)
        cell = register_batch.cell(config, mix, trees, device)
        gaps: Dict[str, float] = {}
        for i in register_batch.checked_pairs(seed, mix):
            p = pool[i]
            _tf32(lower)
            out = judge.control_register(p["xyz0"], p["xyz1"], cell)
            _tf32(False)
            for k, v in judge.judge_register(out, p["xyz0"], p["xyz1"], cell).items():
                gaps[k] = max(gaps.get(k, 0.0), v if math.isfinite(v) else math.inf)
        return gaps
    steps = train_step.checked_steps(train_step.raw_pairs(config, mix, seed), mix)
    cell = train_step.cell(config, mix, trees, device)
    if fault not in (None, "half_batch"):
        raise ValueError(f"unknown fault {fault!r}")
    keep = len(steps[0]) // 2 if fault == "half_batch" else None
    _tf32(lower)
    out = judge.control_train(steps, cell, keep)
    _tf32(False)
    return judge.judge_train(out, steps, cell)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)
    run.require_cards(1)
    bench = run.with_held(run.load_json(run.ROOT, "BENCHMARK.json"))
    cell = run.find_cell(bench, args.workload)[0]
    limits = run.load_json(run.HERE, "limits", cell["name"] + ".json")
    for s in args.seeds:
        t0 = time.perf_counter()
        g = readings(args.workload, s, args.fault, bench=bench)
        ok = all(g.get(k, math.inf) <= v for k, v in limits.items())
        print(json.dumps({"workload": args.workload, "seed": s, "fault": args.fault,
                          "correct": ok, "seconds": time.perf_counter() - t0,
                          "readings": {k: [g.get(k), limits.get(k)] for k in g}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
