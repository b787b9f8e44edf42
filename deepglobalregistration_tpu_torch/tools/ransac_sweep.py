"""RANSAC hypothesis-budget sweep: pick the safeguard default with evidence.

Counterpart of the repo's ``tools/ransac_sweep.py``. The reference's Open3D
safeguard validates 80,000 sequential models
(deep_global_registration.py:302-315, RANSACConvergenceCriteria(4e6,
80000)); the port's safeguard (``ops/ransac.py``) scores
``ransac_hypotheses`` 4-point models at once. This sweep measures recall
(RTE < 0.3 m, RRE < 15 deg, the 3DMatch success bar) on synthetic
low-inlier correspondence sets across budgets, and the time of a call on
the device (between ``torch.cuda.synchronize()`` calls on the card), to
answer:
  1. what budget matches or beats the o3d-80k behaviour, and
  2. whether the reduced 4,096 budget of the batched path costs recall.

Run:  python -m deepglobalregistration_tpu_torch.tools.ransac_sweep \\
          [--trials 30] [--out sweep.json] [--device cpu]
Prints one line per (ratio, budget) and the theoretical hit probabilities,
and writes the results as JSON with ``--out``. Runs on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from ..ops import metrics, ransac
from ..utils.device import generator, resolve_device


def make_pair(rng, n, inlier_ratio, noise=0.01, extent=3.0):
    """Synthetic correspondence set: n pairs, a fraction correct under a random
    rigid transform, the rest matched to random points (1-NN mismatches)."""
    from scipy.spatial.transform import Rotation

    X = (rng.rand(n, 3) * extent).astype(np.float32)
    R = Rotation.random(random_state=rng).as_matrix().astype(np.float32)
    t = (rng.randn(3) * 0.5).astype(np.float32)
    Y = X @ R.T + t
    k = max(int(n * inlier_ratio), 4)
    out = Y.copy()
    out[k:] = (rng.rand(n - k, 3) * extent) @ R.T + t  # outliers: wrong matches
    out[:k] += rng.randn(k, 3).astype(np.float32) * noise
    perm = rng.permutation(n)
    return X[perm], out[perm].astype(np.float32), R, t


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=30)
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--out", default=None)
    ap.add_argument("--budgets", default="1024,4096,16384,65536")
    ap.add_argument("--ratios", default="0.02,0.05,0.10,0.20")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (raises without a card) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    budgets = [int(b) for b in args.budgets.split(",")]
    ratios = [float(r) for r in args.ratios.split(",")]
    rng = np.random.RandomState(0)

    results = {}
    for ratio in ratios:
        pairs = [make_pair(rng, args.n, ratio) for _ in range(args.trials)]
        for h in budgets:
            succ, rtes, rres, secs = 0, [], [], []
            for i, (X, Y, R_gt, t_gt) in enumerate(pairs):
                x = torch.as_tensor(X, device=dev)
                y = torch.as_tensor(Y, device=dev)
                _sync(dev)
                t0 = time.perf_counter()
                res = ransac.ransac_correspondence(
                    x, y, 0.1, num_hypotheses=h, generator=generator(i, dev))
                _sync(dev)
                secs.append(time.perf_counter() - t0)
                rte = float(np.linalg.norm(res.t.cpu().numpy() - t_gt))
                rre = float(np.rad2deg(float(metrics.rotation_error(
                    res.R.cpu().double(), torch.as_tensor(R_gt).double()))))
                rtes.append(rte)
                rres.append(rre)
                succ += (rte < 0.3) and (rre < 15.0)
            # The first call of a budget carries its one-time costs.
            dt = float(np.median(secs))
            results[f"r{ratio}_h{h}"] = {
                "inlier_ratio": ratio, "hypotheses": h,
                "recall": succ / len(pairs),
                "median_rte": float(np.median(rtes)),
                "median_rre": float(np.median(rres)),
                "sec_per_call": dt, "ms_per_call": dt * 1e3,
            }
            print(f"ratio={ratio:.2f} H={h:6d}: recall={succ}/{len(pairs)}"
                  f" med_rte={np.median(rtes):.3f} med_rre={np.median(rres):.2f}"
                  f" {dt * 1e3:.3f} ms/call", flush=True)

    if args.out:
        Path(args.out).write_text(json.dumps(results, indent=2))

    # o3d-80k behaviour: p4 = ratio^4 per hypothesis; 80k sequential
    # validations give expected recall 1-(1-p4)^80000 before refit.
    print("\ntheoretical 4-pt hit probability (no refit):")
    for ratio in ratios:
        p4 = ratio ** 4
        for h in budgets + [80000]:
            p = 1 - (1 - p4) ** h
            print(f"  ratio={ratio:.2f} H={h}: P(>=1 clean sample)={p:.3f}")
    return results


if __name__ == "__main__":
    main()
