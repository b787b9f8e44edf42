"""Synthetic pairs with known ground truth, as numpy float32.

``synthetic_pair`` is a copy of the repo's ``demo.py:synthetic_pair``: four
axis-aligned 3 m planes with 1 cm noise, registered against a rigidly moved,
shuffled copy. ``lidar_like_pair`` is a copy of
``tools/kitti_scale_smoke.py:lidar_like_pair``: a 120k-point LiDAR-like scan
(~20k voxels at 0.3 m, up to 45 m range) against the same points moved by a
20-degree turn about z and a shift.

They serve ``demo.py`` and ``chip_smoke.py`` (its bench pairs, KITTI-scale
pairs and evaluation fixtures). The synthetic datasets of the training and
evaluation loaders (``SyntheticPairDataset``, ``SyntheticLidarPairDataset``,
``SyntheticTrajectoryDataset``) are in ``data/synthetic.py``.
"""

from __future__ import annotations

import numpy as np


def synthetic_pair(n: int = 30000, seed: int = 0):
    """Returns (xyz0, xyz1, T_gt [4, 4])."""
    rng = np.random.RandomState(seed)
    walls = []
    for _ in range(4):
        u = rng.rand(n // 4, 2) * 3
        axis = rng.randint(3)
        pts = np.zeros((n // 4, 3), np.float32)
        pts[:, [i for i in range(3) if i != axis]] = u
        pts[:, axis] = rng.rand() * 3
        walls.append(pts + 0.01 * rng.randn(n // 4, 3))
    xyz0 = np.concatenate(walls).astype(np.float32)
    from scipy.spatial.transform import Rotation

    R = Rotation.from_euler("zyx", [25, 10, -15], degrees=True).as_matrix().astype(np.float32)
    t = np.array([0.4, -0.3, 0.2], np.float32)
    xyz1 = (xyz0 @ R.T + t)[rng.permutation(len(xyz0))]
    T_gt = np.eye(4, dtype=np.float32)
    T_gt[:3, :3], T_gt[:3, 3] = R, t
    return xyz0, xyz1, T_gt


def lidar_like_pair(seed: int = 0, n: int = 120000):
    """Surface-structured scan + rigid transform. Returns (xyz0, xyz1, R, t)."""
    rng = np.random.RandomState(seed)
    n_seed = 15000
    ang = rng.rand(n_seed) * 2 * np.pi
    r = np.clip(np.abs(rng.randn(n_seed)) * 18 + 2, 0, 45)
    z = rng.rand(n_seed) * 3 - 1 + 0.02 * r
    seeds = np.stack([r * np.cos(ang), r * np.sin(ang), z], 1).astype(np.float32)
    for cx, cy, sx, sy in ((12, 5, 4, 8), (-20, 14, 10, 3), (3, -25, 5, 5)):
        m = 1500
        seeds = np.concatenate([seeds, np.stack([
            cx + rng.rand(m).astype(np.float32) * sx,
            cy + rng.rand(m).astype(np.float32) * sy,
            rng.rand(m).astype(np.float32) * 6], 1)]).astype(np.float32)
    idx = rng.randint(0, len(seeds), n)
    xyz0 = (seeds[idx] + 0.05 * rng.randn(n, 3)).astype(np.float32)
    th = 0.35
    R = np.array([[np.cos(th), -np.sin(th), 0],
                  [np.sin(th), np.cos(th), 0], [0, 0, 1]], np.float32)
    t = np.array([1.5, -0.8, 0.1], np.float32)
    xyz1 = np.ascontiguousarray(xyz0 @ R.T + t, np.float32)
    return xyz0, xyz1, R, t
