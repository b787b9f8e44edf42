"""ICP's stop rule with and without the relative rmse floor, on the card.

Counterpart of the JAX package's ``tools/icp_deviation.py``: for
``--pairs`` pairs ``synthetic_pair(n=--n, seed)`` and a grid of initial
perturbations around the ground truth (rotations of 0, 0.5, 2, 5 and 10
degrees about random axes, shifts of 0, 2, 5 and 15 cm, drawn as the JAX
tool draws them), the full-scan ICP at ``2 * --voxel`` runs once with the
legacy ``f32_rmse_floor=1e-3`` and once with the default 0 (Open3D's
absolute criteria), from the same init. Prints the summary as one JSON line
(the JAX tool's keys, plus the device); ``--json`` writes the summary and
every case's row.

    python -m deepglobalregistration_tpu_torch.tools.icp_deviation [--n 5000]
        [--pairs 6] [--voxel 0.05] [--json out.json] [--device cuda]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..ops import icp
from ..utils import device as device_utils
from ..utils.synthetic import synthetic_pair

ANGLES_DEG = (0.0, 0.5, 2.0, 5.0, 10.0)
SHIFTS_M = (0.0, 0.02, 0.05, 0.15)


def rot_deg(Ra: np.ndarray, Rb: np.ndarray) -> float:
    c = (np.trace(Ra.T @ Rb) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def sweep(n: int, pairs: int, voxel: float, device) -> list:
    """One row a case, with the JAX tool's keys."""
    from scipy.spatial.transform import Rotation

    rows = []
    rng = np.random.RandomState(7)
    for seed in range(pairs):
        xyz0, xyz1, T_gt = synthetic_pair(n=n, seed=seed)
        src = torch.as_tensor(xyz0, device=device)
        tgt = torch.as_tensor(xyz1, device=device)
        T_gt = np.asarray(T_gt, np.float64)
        for ang in ANGLES_DEG:
            for sh in SHIFTS_M:
                axis = rng.randn(3)
                axis /= np.linalg.norm(axis)
                dT = np.eye(4, dtype=np.float32)
                dT[:3, :3] = Rotation.from_rotvec(
                    axis * np.radians(ang)).as_matrix().astype(np.float32)
                dT[:3, 3] = rng.randn(3).astype(np.float32) * sh
                T0 = torch.as_tensor(dT @ T_gt.astype(np.float32), device=device)
                res = [icp.registration_icp(src, tgt, 2 * voxel, init=T0,
                                            f32_rmse_floor=floor)
                       for floor in (1e-3, 0.0)]
                Ta, Tb = (r.T.double().cpu().numpy() for r in res)
                rows.append({
                    "seed": seed, "init_rot_deg": ang, "init_shift_m": sh,
                    "iters_floor": int(res[0].iterations),
                    "iters_full": int(res[1].iterations),
                    "dR_deg": rot_deg(Ta[:3, :3], Tb[:3, :3]),
                    "dt_m": float(np.linalg.norm(Ta[:3, 3] - Tb[:3, 3])),
                    "err_floor_rot_deg": rot_deg(Ta[:3, :3], T_gt[:3, :3]),
                    "err_full_rot_deg": rot_deg(Tb[:3, :3], T_gt[:3, :3]),
                    "err_floor_t_m": float(np.linalg.norm(Ta[:3, 3] - T_gt[:3, 3])),
                    "err_full_t_m": float(np.linalg.norm(Tb[:3, 3] - T_gt[:3, 3])),
                })
    return rows


def summarize(rows: list) -> dict:
    dr = np.array([r["dR_deg"] for r in rows])
    dt = np.array([r["dt_m"] for r in rows])
    return {
        "cases": len(rows),
        "max_dR_deg": float(dr.max()), "mean_dR_deg": float(dr.mean()),
        "max_dt_m": float(dt.max()), "mean_dt_m": float(dt.mean()),
        "mean_iters_floor": float(np.mean([r["iters_floor"] for r in rows])),
        "mean_iters_full": float(np.mean([r["iters_full"] for r in rows])),
        "note": "floor=1e-3 (legacy) vs floor=0 (o3d criteria semantics, the "
                "default). Success thresholds: 3DMatch 0.3 m/15 deg, KITTI "
                "0.6 m/5 deg.",
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=5000)
    ap.add_argument("--pairs", type=int, default=6)
    ap.add_argument("--voxel", type=float, default=0.05)
    ap.add_argument("--json", type=str, default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = device_utils.resolve_device(args.device)
    rows = sweep(args.n, args.pairs, args.voxel, dev)
    summary = summarize(rows)
    summary["device"] = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                         else "cpu (plain versions)")
    print(json.dumps(summary), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"summary": summary, "rows": rows}, f, indent=1)
    return summary


if __name__ == "__main__":
    main()
