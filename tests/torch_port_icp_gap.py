"""Full-scan against candidate-list ICP iterations, JAX package beside the port.

    JAX_PLATFORMS=cpu python tests/torch_port_icp_gap.py [--n 120000] [--seed 0]

On ``lidar_like_pair(seed)``'s clouds voxelized at 0.3 m (the KITTI-scale
configuration's input to ICP), from ground truth composed with a 0.05 deg
turn about z and a 3 cm shift (the near-converged init of ``chip_smoke.py``'s
ICP check), runs both ICP modes of both packages on the CPU and prints one
JSON line: each run's iterations and rmse, and each package's candidate-vs-
scan max |dT|. The full scan's d2 is |a|^2 - 2a.b + |b|^2 in f32 in both
packages, whose rounding at ranges of tens of metres exceeds the 1e-6 rmse
stop rule, so the scan may stop later than the candidate path; this script
says how much later in the reference itself. ``--n`` below 120000 gives a
smaller pair.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def near_init(T_gt: np.ndarray, deg: float = 0.05, shift=(0.03, 0.0, 0.0)):
    from scipy.spatial.transform import Rotation

    P = np.eye(4, dtype=np.float32)
    P[:3, :3] = Rotation.from_euler("z", deg, degrees=True).as_matrix()
    P[:3, 3] = shift
    return (T_gt @ P).astype(np.float32)


def icp_gap(n: int = 120000, seed: int = 0, voxel: float = 0.3) -> dict:
    import jax
    import jax.numpy as jnp
    import torch

    from deepglobalregistration_tpu.ops import icp as jicp
    from deepglobalregistration_tpu_torch.ops import icp, sparse_grid
    from deepglobalregistration_tpu_torch.utils.synthetic import lidar_like_pair

    xyz0, xyz1, R, t = lidar_like_pair(seed=seed, n=n)
    T_gt = np.eye(4, dtype=np.float32)
    T_gt[:3, :3], T_gt[:3, 3] = R, t
    sel0 = sparse_grid.voxelize(torch.as_tensor(xyz0), voxel)[0]
    sel1 = sparse_grid.voxelize(torch.as_tensor(xyz1), voxel)[0]
    init = near_init(T_gt)
    mcd = 2 * voxel
    out = {"rows": [int(sel0.shape[0]), int(sel1.shape[0])], "seed": seed, "n": n}
    Ts = {}
    for pkg in ("jax", "port"):
        for mode in ("full", "cand"):
            cand = mode == "cand"
            if pkg == "jax":
                r = jax.jit(lambda a, b, T, c=cand: jicp.registration_icp(
                    a, b, jnp.int32(a.shape[0]), jnp.int32(b.shape[0]), mcd,
                    init=T, use_candidates=c))(
                    sel0.numpy(), sel1.numpy(), init)
                T, it, rmse, ok = (np.asarray(r.T), int(r.iterations),
                                   float(r.inlier_rmse), bool(r.cand_ok))
            else:
                r = icp.registration_icp(sel0, sel1, mcd, init=torch.as_tensor(init),
                                         use_candidates=cand)
                T, it, rmse, ok = r.T.numpy(), r.iterations, r.inlier_rmse, r.cand_ok
            Ts[pkg, mode] = T
            out[f"{pkg}_{mode}"] = {"iterations": it, "rmse": rmse, "cand_ok": ok}
    for pkg in ("jax", "port"):
        out[f"{pkg}_cand_vs_full_max_abs_dT"] = float(
            np.abs(Ts[pkg, "cand"] - Ts[pkg, "full"]).max())
        out[f"{pkg}_iteration_gap"] = (out[f"{pkg}_full"]["iterations"]
                                       - out[f"{pkg}_cand"]["iterations"])
    out["port_vs_jax_full_max_abs_dT"] = float(
        np.abs(Ts["port", "full"] - Ts["jax", "full"]).max())
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=120000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import jax

    jax.config.update("jax_platforms", "cpu")
    print(json.dumps(icp_gap(args.n, args.seed)), flush=True)


if __name__ == "__main__":
    main()
