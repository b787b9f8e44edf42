"""3DMatch benchmark (the repo's ``scripts/test_3dmatch.py``; reference
scripts/test_3dmatch.py:87-182), on the card.

    python -m deepglobalregistration_tpu_torch.scripts.test_3dmatch \
        --threed_match_dir <dir> --weights <ckpt> [--device cpu]

Per-pair RTE/RRE/time over the test scenes' trajectory pairs; success =
RTE < 0.3 m and RRE < 15 deg (config defaults). The stats go to
``<out_dir>/3dmatch-stats.npz`` in the reference's schema ``(num_methods,
num_pairs, 5 = [succ, rte, rre, time, scene_id])``, which the repo's
``scripts/analyze_stats.py`` reads. The time is the host clock around
``register()``, whose numpy result waits for the card.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch.utils.data

from ..config import get_config
from ..core.pipeline import DeepGlobalRegistration
from ..data.threedmatch import ThreeDMatchTrajectoryDataset
from ..utils.timer import Timer

log = logging.getLogger(__name__)


def rte_rre(T_pred, T_gt, rte_thresh, rre_thresh):
    """Success criterion (reference test_3dmatch.py:38-46)."""
    if T_pred is None:
        return np.array([0, np.inf, np.inf])
    rte = np.linalg.norm(T_pred[:3, 3] - T_gt[:3, 3])
    rre = np.rad2deg(np.arccos(
        np.clip((np.trace(T_pred[:3, :3].T @ T_gt[:3, :3]) - 1) / 2, -1 + 1e-16,
                1 - 1e-16)))
    return np.array([rte < rte_thresh and rre < rre_thresh, rte, rre])


def evaluate(methods, method_names, data_loader, config):
    """Register every pair of the loader (items ``(scene, xyz0, xyz1, trans)``,
    the pose ``inv(trans)``) with every method; save and return the stats."""
    tot_num_data = len(data_loader.dataset)
    data_loader_iter = iter(data_loader)

    stats = np.zeros((len(methods), tot_num_data, 5))
    scene_names = sorted({f[0] for f in data_loader.dataset.files})
    scene_index = {s: i for i, s in enumerate(scene_names)}

    for batch_idx in range(tot_num_data):
        batch = next(data_loader_iter)
        sname, xyz0, xyz1, trans = batch[0]
        T_gt = np.linalg.inv(trans)
        sid = scene_index[sname]

        for i, method in enumerate(methods):
            timer = Timer()
            timer.tic()
            T = method.register(xyz0, xyz1)
            wall = timer.toc(average=False)
            stats[i, batch_idx, :3] = rte_rre(T, T_gt, config.success_rte_thresh,
                                              config.success_rre_thresh)
            stats[i, batch_idx, 3] = wall
            stats[i, batch_idx, 4] = sid
            log.info("%s batch %d/%d: succ=%d rte=%.3f rre=%.2f t=%.2fs",
                     method_names[i], batch_idx, tot_num_data,
                     int(stats[i, batch_idx, 0]), stats[i, batch_idx, 1],
                     stats[i, batch_idx, 2], wall)

    # Save + per-scene summary (reference :135-156)
    os.makedirs(config.out_dir, exist_ok=True)
    filename = os.path.join(config.out_dir, "3dmatch-stats.npz")
    np.savez(filename, stats=stats, names=method_names)
    log.info("saved %s", filename)

    for i, name in enumerate(method_names):
        s = stats[i]
        succ = s[:, 0]
        log.info("%s: recall %.4f  TE %.4f m  RE %.4f deg  time %.2f s", name,
                 succ.mean(), s[succ > 0, 1].mean() if succ.any() else np.nan,
                 s[succ > 0, 2].mean() if succ.any() else np.nan, s[:, 3].mean())
        for sname, sid in scene_index.items():
            sel = s[:, 4] == sid
            if sel.any():
                sc = s[sel]
                log.info("  %s: recall %.4f TE %.4f RE %.4f", sname,
                         sc[:, 0].mean(),
                         sc[sc[:, 0] > 0, 1].mean() if sc[:, 0].any() else np.nan,
                         sc[sc[:, 0] > 0, 2].mean() if sc[:, 0].any() else np.nan)
    return stats


def _identity(batch):
    return batch


def main(argv=None) -> np.ndarray:
    """Build the pipeline on ``--device`` and evaluate the test split."""
    config = get_config(argv)
    dgr = DeepGlobalRegistration(config, device=config.device)
    dset = ThreeDMatchTrajectoryDataset(phase="test", transform=None,
                                        random_scale=False, random_rotation=False,
                                        config=config)
    data_loader = torch.utils.data.DataLoader(dset, batch_size=1, shuffle=False,
                                              num_workers=0, collate_fn=_identity)
    return evaluate([dgr], ["DGR-torch"], data_loader, config)


if __name__ == "__main__":
    logging.basicConfig(format="%(asctime)s %(message)s", datefmt="%m/%d %H:%M:%S",
                        level=logging.INFO)
    main()
