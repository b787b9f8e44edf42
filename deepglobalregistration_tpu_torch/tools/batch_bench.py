"""register_batch against register_many and the register() loop on the same pairs.

Counterpart of the JAX package's ``tools/batch_bench.py``: at the bench
configuration (``bench.py``'s ResUNetBN2C FCGF with the committed weights
``weights/fcgf_synthetic.pkl``, bf16 convs, 5 cm voxel), ``--batch`` pairs
``synthetic_pair(n=--points, seed=i % 4)`` (``bench.py``'s stream cycles
its four pairs) go through ``register_batch(..., force_vmapped=True)`` (the
batched program, in sub-batches of ``_MAX_SUB_BATCH``), through
``register_many`` (the pipelined window) and through ``register()`` pair
by pair ("loop"), in turns (batch, many, loop, loop, many, batch) after one
warm-up call of each. One JSON line gives each turn's s/pair, peak device
memory and 1-NN launches, the batched turns' stage seconds and reruns, and
the largest |T_batch - T_register| over the first pairs.

    python -m deepglobalregistration_tpu_torch.tools.batch_bench [--batch 8]
        [--points 30000] [--device cuda]

Times are host clock between device synchronisations. ``--device cpu``
runs the plain versions: a CPU time, not the card's.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from ..config import default_config
from ..core.pipeline import STAGES, DeepGlobalRegistration
from ..ops import knn
from ..utils.synthetic import synthetic_pair

WEIGHTS = Path(__file__).resolve().parents[2] / "weights" / "fcgf_synthetic.pkl"
BENCH = dict(feat_model="ResUNetBN2C", feat_model_n_out=32,
             feat_conv1_kernel_size=7, inlier_model="ResUNetBN2C",
             inlier_conv1_kernel_size=3, voxel_size=0.05,
             inlier_feature_type="ones", weights=str(WEIGHTS),
             dense_extent="256,256,256", bf16=True)
_COUNTED = (knn.nn1_scan, knn.nn1_mma, knn.nn1_scan_batched, knn.nn1_mma_batched)


def _sync(dgr) -> None:
    if dgr.device.type == "cuda":
        torch.cuda.synchronize(dgr.device)


def run_turn(dgr, kind: str, xyz0s, xyz1s, window: int | None = None) -> dict:
    """One call of ``register_batch(force_vmapped=True)`` ("batch"),
    ``register_many`` ("many", at ``window``) or a loop of ``register()``
    ("loop") with the stage timers, the 1-NN launch counts and the peak
    memory set to 0 just before it. "many" and "loop" give each pair's
    ``PairRecord`` (``records``)."""
    for t in list(dgr.stage_timers.values()) + list(dgr.batch_stage_timers.values()):
        t.reset()
    for w in _COUNTED:
        w.launches = 0
    _sync(dgr)
    if dgr.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dgr.device)
    t0 = time.perf_counter()
    records = None
    if kind == "batch":
        T = dgr.register_batch(xyz0s, xyz1s, force_vmapped=True)
    elif kind == "many":
        T = dgr.register_many(xyz0s, xyz1s, window=window)
        records = list(dgr.last_many)
    else:
        T, records = [], []
        for a, b in zip(xyz0s, xyz1s):
            T.append(dgr.register(a, b))
            records.append(dgr.last_record)
        T = np.stack(T)
    _sync(dgr)
    wall = time.perf_counter() - t0
    r = {"kind": kind, "T": T, "s_per_pair": wall / len(xyz0s),
         "peak_mem_gib": (torch.cuda.max_memory_allocated(dgr.device) / 2 ** 30
                          if dgr.device.type == "cuda" else None),
         "launches": {w.__name__: w.launches for w in _COUNTED},
         "register_stage_s": {s: dgr.stage_timers[s].total_time for s in STAGES}}
    if records is not None:
        r["records"] = records
    if kind == "batch":
        lb = {k: list(v) for k, v in dgr.last_batch.items()}
        r.update(batch_stage_s={s: dgr.batch_stage_timers[s].total_time for s in STAGES},
                 batched_program_s=sum(dgr.batch_stage_timers[s].total_time
                                       for s in STAGES),
                 reruns=sum(lb["rerun"]), last_batch=lb)
    return r


def compare(dgr, xyz0s, xyz1s,
            order=("batch", "many", "loop", "loop", "many", "batch")) -> dict:
    """Turns of the paths on the same pairs in one process; returns the
    turns (with their transforms) and each path's mean s/pair."""
    turns = [run_turn(dgr, kind, xyz0s, xyz1s) for kind in order]
    mean = {k: float(np.mean([t["s_per_pair"] for t in turns if t["kind"] == k]))
            for k in set(order)}
    return {"turns": turns, "mean_s_per_pair": mean}


def printable(turn: dict) -> dict:
    """A turn without its transforms, its records as JSON fields."""
    out = {k: v for k, v in turn.items() if k not in ("T", "records")}
    if "records" in turn:
        out["records"] = [{"branch": r.branch, **r.iterations} for r in turn["records"]]
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--points", type=int, default=30000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dgr = DeepGlobalRegistration(default_config(**BENCH), device=args.device)
    pairs = [synthetic_pair(n=args.points, seed=s) for s in range(min(args.batch, 4))]
    stream = [pairs[i % len(pairs)] for i in range(args.batch)]
    xyz0s, xyz1s = [p[0] for p in stream], [p[1] for p in stream]
    run_turn(dgr, "batch", xyz0s, xyz1s)  # warm-up
    run_turn(dgr, "many", xyz0s, xyz1s)
    out = compare(dgr, xyz0s, xyz1s)
    T_batch = next(t["T"] for t in out["turns"] if t["kind"] == "batch")
    out["turns"] = [printable(t) for t in out["turns"]]
    gap = [float(np.abs(T_batch[i] - dgr.register(xyz0s[i], xyz1s[i])).max())
           for i in range(min(2, args.batch))]
    kind = (torch.cuda.get_device_name(dgr.device) if dgr.device.type == "cuda"
            else "cpu (plain versions)")
    print(json.dumps({"device": kind, "batch": args.batch, "points": args.points,
                      "sub_batch": dgr._MAX_SUB_BATCH, **out,
                      "max_abs_T_batch_minus_register": gap}), flush=True)


if __name__ == "__main__":
    main()
