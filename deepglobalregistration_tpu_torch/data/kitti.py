"""KITTI odometry LiDAR pair datasets (the JAX package's ``data/kitti.py``;
reference dataloader/kitti_loader.py:17-286).

GT pose = velo2cam-chained odometry refined by ICP and cached to disk
(kitti_loader.py:138-164). The refinement is the port's full-scan ICP
(``ops/icp.registration_icp``, the ``nn1_scan`` kernel on the card) on the
dataset's device (``config.device``), over both scans coarsened to 5 cm.
The cache file (``"%d_%d_%d.npy"``, a float64 4x4) is the JAX package's, so
either package reads the other's.

A loader's worker processes never run the ICP: under fork a worker cannot
use the card. ``prepare_gt()`` computes every missing pose in the calling
process first (``data/factory.make_data_loader`` calls it whenever the
loader has workers), and a worker that finds no cached pose raises.

Pairs with fewer than 1000 GT matches raise (kitti_loader.py:197-198).
KITTINMPairDataset emits pairs at least MIN_DIST=10 m apart following the
3DFeatNet protocol.
"""

from __future__ import annotations

import glob
import logging
import os
import random
import time

import numpy as np
import torch
import torch.utils.data

from .. import native
from ..ops import icp as icp_ops
from ..utils import device as device_utils
from .base import SPLIT_DIR, PairDataset
from .transforms import sample_random_trans

_kitti_cache: dict = {}
_kitti_icp_cache: dict = {}


def _coarse(xyz: np.ndarray) -> np.ndarray:
    """One point a 5 cm voxel (the smallest index), in index order."""
    c = np.floor(xyz / 0.05).astype(np.int32)
    _, sel = np.unique(c, axis=0, return_index=True)
    return xyz[np.sort(sel)]


def _icp_refine(xyz0: np.ndarray, xyz1: np.ndarray, device: str = "cuda",
                max_dist: float = 0.2, max_iteration: int = 200) -> icp_ops.ICPResult:
    """Full-scan point-to-point ICP of xyz0 onto xyz1 (valid rows, numpy f32)
    on ``device``, from the identity. The candidate lists are not used: the
    refinement starts from raw odometry, whose error can exceed their drift
    bound, and this path is offline, accuracy-critical and cached."""
    dev = device_utils.resolve_device(device)
    return icp_ops.registration_icp(
        torch.as_tensor(xyz0, dtype=torch.float32, device=dev),
        torch.as_tensor(xyz1, dtype=torch.float32, device=dev),
        max_correspondence_distance=max_dist, max_iteration=max_iteration,
        use_candidates=False)


class KITTIPairDataset(PairDataset):
    DATA_FILES = {
        "train": str(SPLIT_DIR / "train_kitti.txt"),
        "val": str(SPLIT_DIR / "val_kitti.txt"),
        "test": str(SPLIT_DIR / "test_kitti.txt"),
    }
    TEST_RANDOM_ROTATION = False
    MIN_MATCHES = 1000

    def __init__(self, phase, transform=None, random_rotation=True,
                 random_scale=True, manual_seed=False, config=None):
        self.root = root = os.path.join(config.kitti_dir, "dataset")
        self.icp_path = config.icp_cache_path
        os.makedirs(self.icp_path, exist_ok=True)
        random_rotation = self.TEST_RANDOM_ROTATION
        super().__init__(phase, transform, random_rotation, random_scale,
                         manual_seed, config)
        self.device = config.device
        self.gt_log = []  # one record a ground-truth ICP run in this process
        logging.info("Loading the subset %s from %s", phase, root)
        self.max_time_diff = config.kitti_max_time_diff

        subset_names = open(self.DATA_FILES[phase]).read().split()
        for dirname in subset_names:
            drive_id = int(dirname)
            inames = self.get_all_scan_ids(drive_id)
            for start_time in inames:
                for time_diff in range(2, self.max_time_diff):
                    pair_time = time_diff + start_time
                    if pair_time in inames:
                        self.files.append((drive_id, start_time, pair_time))

    def get_all_scan_ids(self, drive_id):
        fnames = glob.glob(self.root + "/sequences/%02d/velodyne/*.bin" % drive_id)
        assert len(fnames) > 0, f"no velodyne scans for drive {drive_id} under {self.root}"
        return [int(os.path.split(f)[-1][:-4]) for f in fnames]

    @property
    def velo2cam(self):
        """KITTI raw velodyne->cam0 extrinsics, transposed for row-vector use
        (kitti_loader.py:66-78)."""
        if not hasattr(self, "_velo2cam"):
            R = np.array([7.533745e-03, -9.999714e-01, -6.166020e-04, 1.480249e-02,
                          7.280733e-04, -9.998902e-01, 9.998621e-01, 7.523790e-03,
                          1.480755e-02]).reshape(3, 3)
            T = np.array([-4.069766e-03, -7.631618e-02, -2.717806e-01]).reshape(3, 1)
            self._velo2cam = np.vstack((np.hstack([R, T]), [0, 0, 0, 1])).T
        return self._velo2cam

    def get_video_odometry(self, drive, indices=None, return_all=False):
        data_path = self.root + "/poses/%02d.txt" % drive
        if data_path not in _kitti_cache:
            _kitti_cache[data_path] = np.genfromtxt(data_path)
        return _kitti_cache[data_path] if return_all else _kitti_cache[data_path][indices]

    @staticmethod
    def odometry_to_positions(odometry):
        return np.vstack((odometry.reshape(3, 4), [0, 0, 0, 1]))

    def _get_velodyne_fn(self, drive, t):
        return self.root + "/sequences/%02d/velodyne/%06d.bin" % (drive, t)

    def load_scans(self, idx):
        """Pair ``idx``'s two scans [N, 3] f32 and their odometry positions."""
        drive, t0, t1 = self.files[idx]
        positions = [self.odometry_to_positions(o)
                     for o in self.get_video_odometry(drive, [t0, t1])]
        xyz0 = np.fromfile(self._get_velodyne_fn(drive, t0), dtype=np.float32).reshape(-1, 4)[:, :3]
        xyz1 = np.fromfile(self._get_velodyne_fn(drive, t1), dtype=np.float32).reshape(-1, 4)[:, :3]
        return xyz0, xyz1, positions

    def icp_inputs(self, xyz0, xyz1, positions):
        """The odometry-chained pose M and the ground-truth ICP's clouds: both
        scans coarsened to 5 cm, the source moved by M (f32)."""
        M = (self.velo2cam @ positions[0].T @ np.linalg.inv(positions[1].T)
             @ np.linalg.inv(self.velo2cam)).T
        src = self.apply_transform(_coarse(xyz0), M).astype(np.float32)
        return M, src, _coarse(xyz1).astype(np.float32)

    def _gt_transform(self, drive, t0, t1, xyz0, xyz1, positions):
        """Odometry-chained GT, ICP-refined and cached (kitti_loader.py:138-164)."""
        key = "%d_%d_%d" % (drive, t0, t1)
        filename = os.path.join(self.icp_path, key + ".npy")
        if key in _kitti_icp_cache:
            return _kitti_icp_cache[key]
        if os.path.exists(filename):
            M2 = np.load(filename)
        elif torch.utils.data.get_worker_info() is not None:
            raise RuntimeError(
                f"no cached ground truth {filename}: a loader worker does not "
                "run the ICP; call prepare_gt() before the workers start "
                "(make_data_loader does)")
        else:
            M, src, tgt = self.icp_inputs(xyz0, xyz1, positions)
            t = time.perf_counter()
            res = _icp_refine(src, tgt, self.device)
            M2 = M @ res.T.double().cpu().numpy()
            self.gt_log.append({"key": key, "rows": [len(src), len(tgt)],
                                "iterations": res.iterations,
                                "s": time.perf_counter() - t})
            np.save(filename, M2)
        _kitti_icp_cache[key] = M2
        return M2

    def prepare_gt(self) -> None:
        """Compute, in this process and on the dataset's device, the ground
        truth of every pair in ``files`` that is not cached yet, so that
        worker processes only read the cache."""
        for idx, (drive, t0, t1) in enumerate(self.files):
            self._gt_transform(drive, t0, t1, *self.load_scans(idx))

    def __getitem__(self, idx):
        drive, t0, t1 = self.files[idx]
        xyz0, xyz1, positions = self.load_scans(idx)
        M2 = self._gt_transform(drive, t0, t1, xyz0, xyz1, positions)

        if self.random_rotation:
            T0 = sample_random_trans(xyz0, self.randg, np.pi / 4)
            T1 = sample_random_trans(xyz1, self.randg, np.pi / 4)
            trans = T1 @ M2 @ np.linalg.inv(T0)
            xyz0 = self.apply_transform(xyz0, T0)
            xyz1 = self.apply_transform(xyz1, T1)
        else:
            trans = M2

        matching_search_voxel_size = self.matching_search_voxel_size
        if self.random_scale and random.random() < 0.95:
            scale = self.min_scale + (self.max_scale - self.min_scale) * random.random()
            matching_search_voxel_size *= scale
            xyz0 = scale * xyz0
            xyz1 = scale * xyz1

        p0, c0, p1, c1 = self.voxelize_pair(xyz0, xyz1)
        matches = native.radius_pairs(p0, p1, trans.astype(np.float32),
                                      matching_search_voxel_size)
        if len(matches) < self.MIN_MATCHES:
            raise ValueError(f"Insufficient matches in {drive}, {t0}, {t1}")

        f0 = np.ones((len(p0), 1), np.float32)
        f1 = np.ones((len(p1), 1), np.float32)
        if self.transform:
            c0, f0 = self.transform(c0, f0)
            c1, f1 = self.transform(c1, f1)
        extra = {"drive": drive, "t0": t0, "t1": t1}
        return p0, p1, c0, c1, f0, f1, matches, trans.astype(np.float32), extra


class KITTINMPairDataset(KITTIPairDataset):
    """Pairs >= MIN_DIST meters apart (kitti_loader.py:229-286)."""

    MIN_DIST = 10

    def __init__(self, phase, transform=None, random_rotation=True,
                 random_scale=True, manual_seed=False, config=None):
        self.root = root = os.path.join(config.kitti_dir, "dataset")
        self.icp_path = os.path.join(config.kitti_dir, config.icp_cache_path)
        os.makedirs(self.icp_path, exist_ok=True)
        random_rotation = self.TEST_RANDOM_ROTATION
        PairDataset.__init__(self, phase, transform, random_rotation, random_scale,
                             manual_seed, config)
        self.device = config.device
        self.gt_log = []
        logging.info("Loading the subset %s from %s", phase, root)

        subset_names = open(self.DATA_FILES[phase]).read().split()
        for dirname in subset_names:
            drive_id = int(dirname)
            inames = sorted(self.get_all_scan_ids(drive_id))
            all_odo = self.get_video_odometry(drive_id, return_all=True)
            all_pos = np.array([self.odometry_to_positions(o) for o in all_odo])
            Ts = all_pos[:, :3, 3]
            pdist = np.sqrt(((Ts.reshape(1, -1, 3) - Ts.reshape(-1, 1, 3)) ** 2).sum(-1))
            more_than_10 = pdist > self.MIN_DIST
            curr_time = inames[0]
            while curr_time in inames:
                next_time = np.where(more_than_10[curr_time][curr_time:curr_time + 100])[0]
                if len(next_time) == 0:
                    curr_time += 1
                    continue
                next_time = next_time[0] + curr_time - 1
                if next_time in inames:
                    self.files.append((drive_id, curr_time, next_time))
                    curr_time = next_time + 1
        # Remove problematic sequence (kitti_loader.py:281-286)
        for item in [(8, 15, 58)]:
            if item in self.files:
                self.files.remove(item)
