"""Host-side data augmentation (a copy of the JAX package's
``data/transforms.py``; reference dataloader/transforms.py:14-57).

Augmentation runs in the host data pipeline, in numpy/scipy; the card only
sees the augmented clouds.
"""

from __future__ import annotations

import numpy as np
from scipy.linalg import expm, norm


def _cross_matrix(axis: np.ndarray) -> np.ndarray:
    return np.array([[0, -axis[2], axis[1]],
                     [axis[2], 0, -axis[0]],
                     [-axis[1], axis[0], 0]], dtype=np.float64)


def sample_random_trans(pcd: np.ndarray, randg: np.random.RandomState,
                        rotation_range: float = 360.0) -> np.ndarray:
    """Random rotation about a random axis, recentered on the cloud mean
    (transforms.py:14-23): T = [R | -R @ mean]."""
    axis = randg.rand(3) - 0.5
    angle = rotation_range * np.pi / 180.0 * (randg.rand(1) - 0.5)
    R = expm(_cross_matrix(axis / norm(axis) * angle))
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = R.dot(-np.mean(pcd, axis=0))
    return T


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, coords, feats):
        for t in self.transforms:
            coords, feats = t(coords, feats)
        return coords, feats


class Jitter:
    """Additive gaussian feature noise (transforms.py:36-46)."""

    def __init__(self, mu: float = 0.0, sigma: float = 0.01,
                 randg: np.random.RandomState | None = None):
        self.mu = mu
        self.sigma = sigma
        self.randg = randg or np.random.RandomState()

    def __call__(self, coords, feats):
        feats = feats + np.float32(self.mu) + \
            self.randg.randn(*feats.shape).astype(np.float32) * np.float32(self.sigma)
        return coords, feats
