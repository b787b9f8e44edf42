"""3DMatch datasets (a copy of the JAX package's ``data/threedmatch.py``;
reference dataloader/threedmatch_loader.py:16-196).

Train/val: overlap-filtered fragment pairs from .npz files (key "pcd"), random
scale in [min,max] with p=0.95, independent random SO(3) rotations with GT
``trans = T1 @ inv(T0)``, host voxelization, radius-search GT correspondences
(``native.py``). Test: trajectory pairs from each scene's gt.log reading raw
.ply fragments.
"""

from __future__ import annotations

import glob
import logging
import os
import random

import numpy as np

from ..utils.file import read_trajectory
from ..utils.pointcloud import read_point_cloud
from .. import native
from .base import SPLIT_DIR, PairDataset
from .transforms import sample_random_trans


class IndoorPairDataset(PairDataset):
    OVERLAP_RATIO = None

    def __init__(self, phase, transform=None, random_rotation=True,
                 random_scale=True, manual_seed=False, config=None):
        super().__init__(phase, transform, random_rotation, random_scale,
                         manual_seed, config)
        self.root = root = config.threed_match_dir
        self.use_xyz_feature = config.use_xyz_feature
        logging.info("Loading the subset %s from %s", phase, root)

        subset_names = open(self.DATA_FILES[phase]).read().split()
        for name in subset_names:
            pattern = f"{name}*%.2f.txt" % self.OVERLAP_RATIO
            fnames_txt = glob.glob(os.path.join(root, pattern))
            assert len(fnames_txt) > 0, f"Missing overlap lists {pattern} under {root}"
            for fname_txt in fnames_txt:
                with open(fname_txt) as f:
                    for line in f:
                        parts = line.strip().split()
                        if len(parts) >= 2:
                            self.files.append([parts[0], parts[1]])

    def __getitem__(self, idx):
        file0 = os.path.join(self.root, self.files[idx][0])
        file1 = os.path.join(self.root, self.files[idx][1])
        xyz0 = np.load(file0)["pcd"]
        xyz1 = np.load(file1)["pcd"]
        matching_search_voxel_size = self.matching_search_voxel_size

        if self.random_scale and random.random() < 0.95:
            scale = self.min_scale + (self.max_scale - self.min_scale) * random.random()
            matching_search_voxel_size *= scale
            xyz0 = scale * xyz0
            xyz1 = scale * xyz1

        if self.random_rotation:
            T0 = sample_random_trans(xyz0, self.randg, self.rotation_range)
            T1 = sample_random_trans(xyz1, self.randg, self.rotation_range)
            trans = T1 @ np.linalg.inv(T0)
            xyz0 = self.apply_transform(xyz0, T0)
            xyz1 = self.apply_transform(xyz1, T1)
        else:
            trans = np.identity(4)

        p0, c0, p1, c1 = self.voxelize_pair(xyz0, xyz1)
        matches = native.radius_pairs(p0, p1, trans.astype(np.float32),
                                      matching_search_voxel_size)

        if self.use_xyz_feature:
            f0 = (p0 - p0.mean(0)).astype(np.float32)
            f1 = (p1 - p1.mean(0)).astype(np.float32)
        else:
            f0 = np.ones((len(p0), 1), np.float32)
            f1 = np.ones((len(p1), 1), np.float32)

        if self.transform:
            c0, f0 = self.transform(c0, f0)
            c1, f1 = self.transform(c1, f1)

        extra = {"idx": idx, "file0": file0, "file1": file1}
        return p0, p1, c0, c1, f0, f1, matches, trans.astype(np.float32), extra


class ThreeDMatchPairDataset03(IndoorPairDataset):
    OVERLAP_RATIO = 0.3
    DATA_FILES = {
        "train": str(SPLIT_DIR / "train_3dmatch.txt"),
        "val": str(SPLIT_DIR / "val_3dmatch.txt"),
        "test": str(SPLIT_DIR / "test_3dmatch.txt"),
    }


class ThreeDMatchPairDataset05(ThreeDMatchPairDataset03):
    OVERLAP_RATIO = 0.5


class ThreeDMatchPairDataset07(ThreeDMatchPairDataset03):
    OVERLAP_RATIO = 0.7


class ThreeDMatchTrajectoryDataset(PairDataset):
    """Test-time trajectory pairs (threedmatch_loader.py:144-196)."""

    DATA_FILES = ThreeDMatchPairDataset03.DATA_FILES

    def __init__(self, phase, transform=None, random_rotation=True,
                 random_scale=True, manual_seed=False, scene_id=None, config=None,
                 return_ply_names=False):
        super().__init__(phase, transform, random_rotation, random_scale,
                         manual_seed, config)
        self.root = config.threed_match_dir
        subset_names = open(self.DATA_FILES[phase]).read().split()
        if scene_id is not None:
            subset_names = [subset_names[scene_id]]
        for sname in subset_names:
            traj_file = os.path.join(self.root, sname + "-evaluation/gt.log")
            assert os.path.exists(traj_file), traj_file
            for ctraj in read_trajectory(traj_file):
                self.files.append((sname, ctraj.meta[0], ctraj.meta[1], ctraj.pose))
        self.return_ply_names = return_ply_names

    def __getitem__(self, pair_index):
        sname, i, j, T_gt = self.files[pair_index]
        ply0 = os.path.join(self.root, sname, f"cloud_bin_{i}.ply")
        ply1 = os.path.join(self.root, sname, f"cloud_bin_{j}.ply")
        if self.return_ply_names:
            return sname, ply0, ply1, T_gt
        return sname, read_point_cloud(ply0), read_point_cloud(ply1), T_gt
