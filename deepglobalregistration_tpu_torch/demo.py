"""Registration demo (the repo's ``demo.py``; reference demo.py:14-48), on the card.

    python -m deepglobalregistration_tpu_torch.demo [--device cpu]
    python -m deepglobalregistration_tpu_torch.demo --weights W --pcd0 A.ply --pcd1 B.ply

With ``--weights`` it registers the given PLY pair. Without, it registers
``utils/synthetic.synthetic_pair()`` (a room scan against a rigidly moved
copy of itself) with the bundled ``weights/fcgf_synthetic.pkl`` (trained
FCGF features, random inlier net) and prints the errors against the ground
truth. Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import logging
from pathlib import Path

import torch

from .config import get_config
from .core.pipeline import DeepGlobalRegistration
from .ops import metrics
from .utils.pointcloud import read_point_cloud
from .utils.synthetic import synthetic_pair

BUNDLED = Path(__file__).resolve().parent.parent / "weights" / "fcgf_synthetic.pkl"


def main(argv=None) -> dict:
    """Run the demo; returns the estimated ``T`` and, for the synthetic pair,
    ``rte`` (m), ``rre`` (deg) and ``success`` at 0.3 m / 15 deg."""
    config = get_config(argv)
    if config.weights:
        dgr = DeepGlobalRegistration(config, device=config.device)
        T = dgr.register(read_point_cloud(config.pcd0), read_point_cloud(config.pcd1))
        print("Estimated transformation:\n", T)
        return {"T": T}

    print("No --weights given: running the synthetic self-registration demo.")
    if BUNDLED.exists():
        config.weights = str(BUNDLED)
    else:  # the fallback of the repo's demo.py:72-77, random nets
        config.feat_model = "ResUNetBN2C"
        config.feat_model_n_out = 32
        config.feat_conv1_kernel_size = 7
        config.inlier_model = "ResUNetBN2C"
        config.voxel_size = 0.05
    dgr = DeepGlobalRegistration(config, device=config.device)
    xyz0, xyz1, T_gt = synthetic_pair()
    T = dgr.register(xyz0, xyz1)
    ok, rte, rre = metrics.rte_rre(torch.as_tensor(T, dtype=torch.float32),
                                   torch.as_tensor(T_gt), 0.3, 15.0)
    print("Estimated transformation:\n", T)
    print(f"vs ground truth: RTE {float(rte) * 100:.2f} cm, RRE {float(rre):.2f} deg, "
          f"success(0.3m/15deg)={bool(ok)}")
    if not BUNDLED.exists():
        print("(random-initialized networks: the learned inlier gate is "
              "untrained, so the pipeline exercises the safeguard/ICP path)")
    elif not dgr.inlier_trained:
        print("(feature-only weights: FCGF is trained but the learned inlier "
              "gate is untrained — weights may be conservative)")
    return {"T": T, "rte": float(rte), "rre": float(rre), "success": bool(ok)}


if __name__ == "__main__":
    logging.basicConfig(format="%(asctime)s %(message)s", datefmt="%m/%d %H:%M:%S",
                        level=logging.INFO)
    main()
