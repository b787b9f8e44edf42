"""Pair-dataset base class (a copy of the JAX package's ``data/base.py``;
reference dataloader/base_loader.py:101-139).

Datasets produce per-pair 9-tuples of numpy arrays:
(xyz0, xyz1, coords0, coords1, feats0, feats1, matches, trans, extra) —
exactly the reference item schema — which the collator pads into a
``PairBatch`` (data/collate.py). All dataset code runs on the host.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np

SPLIT_DIR = Path(__file__).parent / "split"


class PairDataset:
    AUGMENT = None

    def __init__(self, phase, transform=None, random_rotation=True,
                 random_scale=True, manual_seed=False, config=None):
        self.phase = phase
        self.files = []
        self.transform = transform
        self.voxel_size = config.voxel_size
        self.matching_search_voxel_size = (
            config.voxel_size * config.positive_pair_search_voxel_size_multiplier)
        self.random_scale = random_scale
        self.min_scale = config.min_scale
        self.max_scale = config.max_scale
        self.random_rotation = random_rotation
        self.rotation_range = config.rotation_range
        self.randg = np.random.RandomState()
        if manual_seed:
            self.reset_seed()

    def reset_seed(self, seed: int = 0):
        logging.info("Resetting the data loader seed to %d", seed)
        self.randg.seed(seed)

    @staticmethod
    def apply_transform(pts: np.ndarray, trans: np.ndarray) -> np.ndarray:
        return pts @ trans[:3, :3].T + trans[:3, 3]

    def voxelize_pair(self, xyz0: np.ndarray, xyz1: np.ndarray):
        """Host-side quantization (one point per voxel, smallest index kept),
        matching ME.utils.sparse_quantize usage in the loaders, through the
        port's binding of the native C++ engine (``native.py``)."""
        from .. import native

        p0, c0 = native.voxelize(np.ascontiguousarray(xyz0, np.float32), self.voxel_size)
        p1, c1 = native.voxelize(np.ascontiguousarray(xyz1, np.float32), self.voxel_size)
        return p0, c0, p1, c1

    def __len__(self):
        return len(self.files)
