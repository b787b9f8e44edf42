"""register()'s stage split at the bench and KITTI-scale configurations,
and whether repeat calls give the same bits.

At the bench configuration (``bench.py``'s ResUNetBN2C FCGF with the
committed weights, bf16, 5 cm; ``synthetic_pair(n=30000, seed=0..3)``) and
the KITTI-scale one (``tools/kitti_scale_smoke.py``'s: 0.3 m, conv1 = 5,
seeded random nets; ``lidar_like_pair(seed=0..2)``): one warm-up call, then
``--turns`` turns over the pairs. One JSON line gives each configuration's
s/pair, each stage's mean seconds, and whether every turn's transforms
equal the first turn's bit for bit (with the largest gap).

    python3 deepglobalregistration_tpu_torch/tools/stage_split.py [--root DIR]
        [--turns 3] [--device cuda]

``--root``: the checkout whose ``deepglobalregistration_tpu_torch`` is
imported (default: the one holding this file), so that two commits are
compared in one process's environment, in turns: unpack the other commit
with ``git archive`` and pass its directory. Times are host clock between
device synchronisations; ``--device cpu`` runs the plain versions.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parents[2]
BENCH = dict(feat_model="ResUNetBN2C", feat_model_n_out=32,
             feat_conv1_kernel_size=7, inlier_model="ResUNetBN2C",
             inlier_conv1_kernel_size=3, voxel_size=0.05,
             inlier_feature_type="ones", dense_extent="256,256,256", bf16=True)
KITTI = dict(feat_model="ResUNetBN2C", feat_model_n_out=32,
             feat_conv1_kernel_size=5, inlier_model="ResUNetBN2C",
             inlier_conv1_kernel_size=3, voxel_size=0.3,
             inlier_feature_type="ones", dense_extent="384,384,48", bf16=True)


def split(root: Path, turns: int, device: str) -> dict:
    sys.path.insert(0, str(root))
    import torch

    from deepglobalregistration_tpu_torch.config import default_config
    from deepglobalregistration_tpu_torch.core.pipeline import (
        STAGES, DeepGlobalRegistration)
    from deepglobalregistration_tpu_torch.utils.synthetic import (
        lidar_like_pair, synthetic_pair)

    out = {"root": str(root)}
    for label, cfg, pairs in (
            ("bench", dict(BENCH, weights=str(root / "weights" / "fcgf_synthetic.pkl")),
             [synthetic_pair(n=30000, seed=s)[:2] for s in range(4)]),
            ("kitti", KITTI, [lidar_like_pair(seed=s)[:2] for s in range(3)])):
        dgr = DeepGlobalRegistration(default_config(**cfg), device=device)
        dgr.register(*pairs[0])
        for t in dgr.stage_timers.values():
            t.reset()
        sync = torch.cuda.synchronize if dgr.device.type == "cuda" else (lambda: None)
        sync()
        t0 = time.perf_counter()
        Ts = [[dgr.register(*p) for p in pairs] for _ in range(turns)]
        sync()
        gaps = [float(np.abs(a - b).max()) for turn in Ts[1:] for a, b in zip(turn, Ts[0])]
        out[label] = {"s_per_pair": (time.perf_counter() - t0) / (turns * len(pairs)),
                      "stage_s": {s: dgr.stage_timers[s].avg for s in STAGES},
                      "turns_same_bits": all(np.array_equal(a, b) for turn in Ts[1:]
                                             for a, b in zip(turn, Ts[0])),
                      "max_abs_T_gap_between_turns": max(gaps, default=0.0)}
    if device == "cuda":
        out["device"] = torch.cuda.get_device_name(0)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=HERE)
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    r = split(args.root.resolve(), args.turns, args.device)
    print(json.dumps({"stage_split": r}), flush=True)
    return r


if __name__ == "__main__":
    main()
