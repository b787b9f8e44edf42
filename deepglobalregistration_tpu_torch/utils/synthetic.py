"""Synthetic room-scan pair (a copy of the repo's ``demo.py:synthetic_pair``):
four axis-aligned 3 m planes with 1 cm noise, registered against a rigidly
moved, shuffled copy. Returns (xyz0, xyz1, T_gt) as float32 numpy."""

from __future__ import annotations

import numpy as np


def synthetic_pair(n: int = 30000, seed: int = 0):
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
