"""KITTI benchmark (the repo's ``scripts/test_kitti.py``; reference
scripts/test_kitti.py:59-143), on the card.

    python -m deepglobalregistration_tpu_torch.scripts.test_kitti \
        --kitti_dir <dir> --weights <ckpt> --dataset KITTINMPairDataset [--device cpu]

The evaluation loop of the 3DMatch script over a KITTI loader, with
thresholds TE < 0.6 m, RE < 5 deg (reference :33-34); the per-pair time is
the host clock around ``register()``. Stats go to
``<out_dir>/kitti-stats.npz`` in the same schema. The loader has
``--test_num_workers`` worker processes; the ground-truth ICP runs on the
card in this process before they start (``data/factory.make_data_loader``).
"""

from __future__ import annotations

import logging
import os

import numpy as np

from ..config import get_config
from ..core.pipeline import DeepGlobalRegistration
from ..data.factory import make_data_loader
from ..utils.timer import Timer

log = logging.getLogger(__name__)

TE_THRESH = 0.6  # m (reference test_kitti.py:33)
RE_THRESH = 5.0  # deg (reference test_kitti.py:34)


def evaluate(config, data_loader, method):
    """Register every pair of the loader's collated batches (batch size 1)
    against its ``T_gt``; save and return the stats [N, 5]."""
    data_iter = iter(data_loader)
    n = len(data_loader.dataset)
    stats = np.zeros((n, 5))

    for i in range(n):
        batch = next(data_iter)
        xyz0 = batch["pcd0"][0]
        xyz1 = batch["pcd1"][0]
        T_gt = np.asarray(batch["T_gt"][0])

        timer = Timer()
        timer.tic()
        T = method.register(xyz0, xyz1)
        wall = timer.toc(average=False)

        te = np.linalg.norm(T[:3, 3] - T_gt[:3, 3])
        re = np.rad2deg(np.arccos(np.clip(
            (np.trace(T[:3, :3].T @ T_gt[:3, :3]) - 1) / 2, -0.9999, 0.9999)))
        stats[i] = [te < TE_THRESH and re < RE_THRESH, te, re, wall, 0]
        log.info("pair %d/%d succ=%d te=%.3f re=%.3f t=%.2fs", i, n,
                 int(stats[i, 0]), te, re, wall)

    succ = stats[:, 0] > 0
    log.info("KITTI: recall %.4f  TE %.4f m  RE %.4f deg  time %.2f s",
             succ.mean(), stats[succ, 1].mean() if succ.any() else np.nan,
             stats[succ, 2].mean() if succ.any() else np.nan, stats[:, 3].mean())
    os.makedirs(config.out_dir, exist_ok=True)
    np.savez(os.path.join(config.out_dir, "kitti-stats.npz"), stats=stats[None])
    return stats


def main(argv=None) -> np.ndarray:
    """Build the pipeline on ``--device`` and evaluate the KITTI test split."""
    config = get_config(argv)
    if config.dataset not in ("KITTIPairDataset", "KITTINMPairDataset",
                              "SyntheticLidarPairDataset"):
        config.dataset = "KITTINMPairDataset"
    dgr = DeepGlobalRegistration(config, device=config.device)
    loader = make_data_loader(config, "test", batch_size=1,
                              num_workers=config.test_num_workers, shuffle=False)
    return evaluate(config, loader, dgr)


if __name__ == "__main__":
    logging.basicConfig(format="%(asctime)s %(message)s", datefmt="%m/%d %H:%M:%S",
                        level=logging.INFO)
    main()
