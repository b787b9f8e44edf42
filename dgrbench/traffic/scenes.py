"""Procedural scans with exact ground truth: indoor rooms and street scenes.

A frozen copy of the program's synthetic scene generators
(``data/synthetic.py``: ``make_room``, ``crop_view``, ``make_outdoor_scene``,
``_lidar_views``; ``data/transforms.py``: ``sample_random_trans``), so that
later changes to the program's copies do not move the benchmark's traffic.
Every function draws from the ``numpy.random.RandomState`` it is given.
"""

from __future__ import annotations

import numpy as np
from scipy.linalg import expm, norm


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


def lidar_views(rng: np.random.RandomState, scene: np.ndarray,
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
