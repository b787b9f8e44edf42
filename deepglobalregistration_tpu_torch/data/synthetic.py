"""Procedural indoor and outdoor scan pairs with exact ground truth (a copy
of the JAX package's ``data/synthetic.py``).

With no 3DMatch/KITTI data in the repo, the train -> validate -> benchmark
chain (reference flow core/trainer.py:120-155 + scripts/test_3dmatch.py:87-156)
runs on procedurally generated "room scans": plane-dominated clouds with
clutter, two partially overlapping crops, additive sensor noise, and the
reference's augmentation recipe (random SO(3) per cloud, GT trans =
T1 @ inv(T0), radius-matched GT correspondences — mirrors
dataloader/threedmatch_loader.py:48-124); and LiDAR-scale street scenes
(``SyntheticLidarPairDataset``). ``utils/synthetic.py`` beside it holds the
demo's and the KITTI-scale smoke's pairs.

Every item is a pure function of (phase, index): train/val/test draw from
disjoint seed ranges, so the suite is reproducible and leakage-free.
"""

from __future__ import annotations

import numpy as np

from .. import native
from .base import PairDataset
from .transforms import sample_random_trans


def _surface_relief(rng: np.random.RandomState, u: np.ndarray,
                    v: np.ndarray) -> np.ndarray:
    """Smooth pseudo-random height field h(u, v): a mixture of sinusoids with
    wavelengths 0.3-1.2 m and amplitudes a few cm. Plane points displaced by
    this are locally distinctive at FCGF's receptive scale (~0.5 m at 5 cm
    voxels) — perfectly flat planes are feature-ambiguous everywhere, which
    capped learned 1-NN hit ratios near zero (round-3 e2e finding)."""
    h = np.zeros_like(u)
    for _ in range(6):
        freq = 2 * np.pi / (0.3 + 0.9 * rng.rand())  # wavelength 0.3-1.2 m
        direc = rng.randn(2)
        direc /= np.linalg.norm(direc)
        phase = 2 * np.pi * rng.rand()
        amp = 0.01 + 0.04 * rng.rand()
        h += amp * np.sin(freq * (u * direc[0] + v * direc[1]) + phase)
    return h


def make_room(rng: np.random.RandomState, n: int) -> np.ndarray:
    """Surface-heavy synthetic room: axis-aligned relief-textured planes
    (walls/floor), clutter boxes/spheres/cylinders, and mild Gaussian sensor
    noise. Extents ~2.5-4 m."""
    ext = 2.5 + 1.5 * rng.rand(3)
    pts = []
    n_planes = 4 + rng.randint(3)  # 4-6 planes
    n_clutter = 3 + rng.randint(3)  # 3-5 objects
    per_plane = n // (n_planes + n_clutter // 2)
    for _ in range(n_planes):
        axis = rng.randint(3)
        u = rng.rand(per_plane, 2)
        p = np.zeros((per_plane, 3), np.float32)
        others = [i for i in range(3) if i != axis]
        p[:, others[0]] = u[:, 0] * ext[others[0]]
        p[:, others[1]] = u[:, 1] * ext[others[1]]
        p[:, axis] = rng.rand() * ext[axis] + _surface_relief(
            rng, p[:, others[0]], p[:, others[1]])
        pts.append(p)
    for _ in range(n_clutter):
        c = rng.rand(3) * ext * 0.8
        m = per_plane // 2
        kind = rng.randint(3)
        if kind == 0:  # box shell
            s = 0.15 + 0.45 * rng.rand(3)
            face = rng.randint(3, size=m)
            u = rng.rand(m, 3)
            u[np.arange(m), face] = (rng.rand(m) < 0.5).astype(np.float64)
            q = c + (u - 0.5) * s
        elif kind == 1:  # sphere shell
            r = 0.1 + 0.25 * rng.rand()
            d = rng.randn(m, 3)
            d /= np.linalg.norm(d, axis=1, keepdims=True)
            q = c + r * d
        else:  # open cylinder shell
            r = 0.08 + 0.2 * rng.rand()
            h = 0.2 + 0.6 * rng.rand()
            ax = rng.randint(3)
            th = 2 * np.pi * rng.rand(m)
            q = np.empty((m, 3))
            others = [i for i in range(3) if i != ax]
            q[:, others[0]] = r * np.cos(th)
            q[:, others[1]] = r * np.sin(th)
            q[:, ax] = h * (rng.rand(m) - 0.5)
            q += c
        pts.append(q.astype(np.float32))
    cloud = np.concatenate(pts).astype(np.float32)
    cloud += (0.004 * rng.randn(*cloud.shape)).astype(np.float32)
    return cloud


def crop_view(rng: np.random.RandomState, cloud: np.ndarray,
              keep: float) -> np.ndarray:
    """Half-space crop keeping ~`keep` of the points (a partial view)."""
    d = rng.randn(3)
    d /= np.linalg.norm(d)
    proj = cloud @ d
    thresh = np.quantile(proj, 1.0 - keep)
    return cloud[proj >= thresh]


class SyntheticTrajectoryDataset:
    """Held-out raw-pair test set in the trajectory-dataset convention
    (threedmatch.py ThreeDMatchTrajectoryDataset / reference
    threedmatch_loader.py:144-196): items are ``(scene, xyz0, xyz1, trans)``
    where ``inv(trans)`` is the pose register(xyz0, xyz1) should produce —
    the convention scripts/test_3dmatch.py's evaluate() expects. Seeds are
    disjoint from SyntheticPairDataset's train/val ranges; pairs group into
    a few pseudo-scenes so the per-scene recall table exercises."""

    SEED_BASE = 3_000_000
    N_SCENES = 4
    PAIRS_PER_SCENE = 8

    def __init__(self, n_points: int = 20000, n_scenes: int | None = None,
                 pairs_per_scene: int | None = None):
        self.n_points = n_points
        n_scenes = n_scenes or self.N_SCENES
        pairs = pairs_per_scene or self.PAIRS_PER_SCENE
        self.files = [(f"synthetic-scene-{s}", s * pairs + p)
                      for s in range(n_scenes) for p in range(pairs)]

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx):
        sname, seed = self.files[idx]
        rng = np.random.RandomState(self.SEED_BASE + seed)
        room = make_room(rng, self.n_points)
        keep = 0.7 + 0.2 * rng.rand()
        xyz0 = crop_view(rng, room, keep)
        xyz1 = crop_view(rng, room, keep)
        T0 = sample_random_trans(xyz0, rng, 360.0)
        T1 = sample_random_trans(xyz1, rng, 360.0)
        T_reg = T1 @ np.linalg.inv(T0)  # register(xyz0, xyz1) ground truth
        xyz0 = (xyz0 @ T0[:3, :3].T + T0[:3, 3]).astype(np.float32)
        xyz1 = (xyz1 @ T1[:3, :3].T + T1[:3, 3]).astype(np.float32)
        return sname, xyz0, xyz1, np.linalg.inv(T_reg)


def make_outdoor_scene(rng: np.random.RandomState, n: int) -> np.ndarray:
    """KITTI-scale procedural street scene: relief ground (~80 m), building
    box shells, car-sized boxes, pole/trunk cylinders. Returns ~n points."""
    half = 40.0 + 10.0 * rng.rand()
    pts = []
    n_ground = n // 2
    g = np.empty((n_ground, 3), np.float32)
    g[:, 0] = (rng.rand(n_ground) * 2 - 1) * half
    g[:, 1] = (rng.rand(n_ground) * 2 - 1) * half
    h = np.zeros(n_ground)
    for _ in range(5):  # long-wavelength terrain undulation
        freq = 2 * np.pi / (8.0 + 24.0 * rng.rand())
        d = rng.randn(2)
        d /= np.linalg.norm(d)
        h += (0.05 + 0.25 * rng.rand()) * np.sin(
            freq * (g[:, 0] * d[0] + g[:, 1] * d[1]) + 2 * np.pi * rng.rand())
    g[:, 2] = h
    pts.append(g)

    n_bld = 6 + rng.randint(6)
    n_car = 8 + rng.randint(8)
    n_pole = 6 + rng.randint(8)
    per_bld = (n // 3) // n_bld
    per_car = (n // 8) // n_car
    per_pole = (n // 24) // n_pole
    for _ in range(n_bld):  # building shells (walls only, no roof points)
        c = (rng.rand(2) * 2 - 1) * (half * 0.8)
        sx, sy = 5 + 15 * rng.rand(2)
        hz = 3 + 9 * rng.rand()
        face = rng.randint(2, size=per_bld)  # 0: +-x wall, 1: +-y wall
        side = (rng.rand(per_bld) < 0.5) * 2.0 - 1.0
        u = rng.rand(per_bld, 2)
        q = np.empty((per_bld, 3), np.float32)
        q[:, 0] = np.where(face == 0, side * sx / 2, (u[:, 0] - 0.5) * sx)
        q[:, 1] = np.where(face == 1, side * sy / 2, (u[:, 0] - 0.5) * sy)
        q[:, 2] = u[:, 1] * hz
        q[:, :2] += c
        pts.append(q)
    for _ in range(n_car):  # car-sized box shells on the ground
        c = (rng.rand(2) * 2 - 1) * (half * 0.9)
        s = np.array([1.8, 4.2, 1.5]) * (0.8 + 0.4 * rng.rand())
        yaw = 2 * np.pi * rng.rand()
        face = rng.randint(3, size=per_car)
        u = rng.rand(per_car, 3)
        u[np.arange(per_car), face] = (rng.rand(per_car) < 0.5).astype(float)
        q = ((u - 0.5) * s).astype(np.float32)
        ca, sa = np.cos(yaw), np.sin(yaw)
        q[:, :2] = q[:, :2] @ np.array([[ca, sa], [-sa, ca]], np.float32)
        q[:, :2] += c
        q[:, 2] += s[2] / 2
        pts.append(q)
    for _ in range(n_pole):  # poles / trunks
        c = (rng.rand(2) * 2 - 1) * (half * 0.9)
        r = 0.1 + 0.3 * rng.rand()
        hz = 3 + 5 * rng.rand()
        th = 2 * np.pi * rng.rand(per_pole)
        q = np.empty((per_pole, 3), np.float32)
        q[:, 0] = c[0] + r * np.cos(th)
        q[:, 1] = c[1] + r * np.sin(th)
        q[:, 2] = rng.rand(per_pole) * hz
        pts.append(q)
    cloud = np.concatenate(pts).astype(np.float32)
    cloud += (0.02 * rng.randn(*cloud.shape)).astype(np.float32)
    return cloud


def _lidar_views(rng: np.random.RandomState, scene: np.ndarray,
                 min_dist: float = 10.0, sensor_range: float = 45.0):
    """Two ego-frame range-cropped views >= min_dist apart (the KITTI-NM
    pair-selection protocol, reference kitti_loader.py:229-286) + the GT map
    from view-0 to view-1 coordinates."""
    o0 = (rng.rand(2) - 0.5) * 20.0
    ang = 2 * np.pi * rng.rand()
    dist = min_dist + 5.0 * rng.rand()
    o1 = o0 + dist * np.array([np.cos(ang), np.sin(ang)])
    # Absolute heading is arbitrary, but the RELATIVE yaw between the two
    # vantages follows the KITTI odometry protocol: frames >= 10 m apart in
    # a drive differ by the vehicle's heading drift (typically well under
    # 30 deg), not by a uniform 0-360 spin. An independent uniform yaw per
    # view would demand fully yaw-invariant features — a harder task than
    # the benchmark this is standing in for.
    yaw0 = 2 * np.pi * rng.rand()
    yaws = (yaw0, yaw0 + (rng.rand() - 0.5) * np.pi / 3)
    views, poses = [], []
    for o, yaw in zip((o0, o1), yaws):
        ca, sa = np.cos(yaw), np.sin(yaw)
        R = np.array([[ca, -sa, 0], [sa, ca, 0], [0, 0, 1]], np.float64)
        t = np.array([o[0], o[1], 1.7])  # sensor ~1.7 m above ground
        keep = np.linalg.norm(scene[:, :2] - o[None, :], axis=1) < sensor_range
        views.append(((scene[keep] - t) @ R).astype(np.float32))  # R^T (w - t)
        poses.append((R, t))
    (R0, t0), (R1, t1) = poses
    trans = np.eye(4)
    trans[:3, :3] = R1.T @ R0
    trans[:3, 3] = R1.T @ (t0 - t1)
    return views[0], views[1], trans.astype(np.float32)


class SyntheticPairDataset(PairDataset):
    """Procedural pairs; overlap ~60-85%. No on-disk data required."""

    SEED_BASE = {"train": 0, "val": 1_000_000, "test": 2_000_000}
    SIZE = {"train": 4000, "val": 32, "test": 32}
    DATA_FILES = {"train": None, "val": None, "test": None}  # registry compat

    def __init__(self, phase, transform=None, random_rotation=True,
                 random_scale=True, manual_seed=False, config=None):
        super().__init__(phase, transform, random_rotation, random_scale,
                         manual_seed, config)
        self.n_points = int(getattr(config, "synthetic_points", 20000) or 20000)
        self.files = list(range(self.SIZE[phase]))
        self.seed_base = self.SEED_BASE[phase]

    def __getitem__(self, idx):
        rng = np.random.RandomState(self.seed_base + int(idx))
        room = make_room(rng, self.n_points)
        keep = 0.7 + 0.2 * rng.rand()
        xyz0 = crop_view(rng, room, keep)
        xyz1 = crop_view(rng, room, keep)

        matching_search_voxel_size = self.matching_search_voxel_size
        if self.random_scale and rng.rand() < 0.95:
            scale = self.min_scale + (self.max_scale - self.min_scale) * rng.rand()
            matching_search_voxel_size *= scale
            xyz0 = scale * xyz0
            xyz1 = scale * xyz1

        if self.random_rotation:
            T0 = sample_random_trans(xyz0, rng, self.rotation_range)
            T1 = sample_random_trans(xyz1, rng, self.rotation_range)
            trans = T1 @ np.linalg.inv(T0)
            xyz0 = self.apply_transform(xyz0, T0)
            xyz1 = self.apply_transform(xyz1, T1)
        else:
            trans = np.identity(4)

        p0, c0, p1, c1 = self.voxelize_pair(xyz0, xyz1)
        matches = native.radius_pairs(p0, p1, trans.astype(np.float32),
                                      matching_search_voxel_size)
        f0 = np.ones((len(p0), 1), np.float32)
        f1 = np.ones((len(p1), 1), np.float32)
        if self.transform:
            c0, f0 = self.transform(c0, f0)
            c1, f1 = self.transform(c1, f1)
        extra = {"idx": idx}
        return p0, p1, c0, c1, f0, f1, matches, trans.astype(np.float32), extra


class SyntheticLidarPairDataset(PairDataset):
    """Procedural outdoor LiDAR-scale pairs (the KITTI-NM protocol analogue,
    reference dataloader/kitti_loader.py:229-286): two ego-frame views of a
    street scene >= 10 m apart, 0.3 m voxels. Unlike the indoor dataset the
    GT pose comes from the vantage difference itself (like KITTI odometry GT),
    so test pairs carry a real transform with no augmentation; train-phase
    random rotation/scale compose on top."""

    SEED_BASE = {"train": 4_000_000, "val": 5_000_000, "test": 6_000_000}
    SIZE = {"train": 2000, "val": 32, "test": 32}
    DATA_FILES = {"train": None, "val": None, "test": None}  # registry compat

    def __init__(self, phase, transform=None, random_rotation=True,
                 random_scale=True, manual_seed=False, config=None):
        super().__init__(phase, transform, random_rotation, random_scale,
                         manual_seed, config)
        self.n_points = int(getattr(config, "synthetic_points", 30000) or 30000)
        self.files = list(range(self.SIZE[phase]))
        self.seed_base = self.SEED_BASE[phase]
        # KITTI rotation-augmentation protocol, not the indoor 360-degree
        # default: the reference passes np.pi/4 into a DEGREES parameter
        # (kitti_loader.py:228 -> transforms.py:14-23), i.e. +-0.4 deg —
        # LiDAR scans are gravity-aligned and the relative yaw already comes
        # from the ego motion. Training this analogue with full SO(3)
        # augmentation (the config default, 360) made the FCGF stage
        # unlearnable at this step budget (val 1-NN hit ratio stuck at 0.3%).
        self.rotation_range = np.pi / 4

    def __getitem__(self, idx):
        rng = np.random.RandomState(self.seed_base + int(idx))
        scene = make_outdoor_scene(rng, self.n_points * 2)
        xyz0, xyz1, trans = _lidar_views(rng, scene)
        matching_search_voxel_size = self.matching_search_voxel_size
        if self.random_scale and rng.rand() < 0.95:
            scale = self.min_scale + \
                (self.max_scale - self.min_scale) * rng.rand()
            matching_search_voxel_size *= scale
            xyz0 = (scale * xyz0).astype(np.float32)
            xyz1 = (scale * xyz1).astype(np.float32)
            trans = trans.copy()
            trans[:3, 3] *= scale
        if self.random_rotation:
            T0 = sample_random_trans(xyz0, rng, self.rotation_range)
            T1 = sample_random_trans(xyz1, rng, self.rotation_range)
            trans = T1 @ trans @ np.linalg.inv(T0)
            xyz0 = self.apply_transform(xyz0, T0).astype(np.float32)
            xyz1 = self.apply_transform(xyz1, T1).astype(np.float32)

        p0, c0, p1, c1 = self.voxelize_pair(xyz0, xyz1)
        matches = native.radius_pairs(p0, p1, trans.astype(np.float32),
                                      matching_search_voxel_size)
        f0 = np.ones((len(p0), 1), np.float32)
        f1 = np.ones((len(p1), 1), np.float32)
        if self.transform:
            c0, f0 = self.transform(c0, f0)
            c1, f1 = self.transform(c1, f1)
        extra = {"idx": idx}
        return p0, p1, c0, c1, f0, f1, matches, trans.astype(np.float32), extra
