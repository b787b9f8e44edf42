"""Port vs JAX package: TSDF fragment integration (``utils/integration.py``).

The JAX version is numpy on the host, in float64 geometry; the port keeps
that geometry in float64 on its device (here the CPU), so the volumes and
the extracted points must equal the JAX version's bit for bit: on the flat
wall of ``tests/test_integration_tool.py``, on a seeded 4-frame sequence of
moving cameras (the volume run in several x slabs), and through
``integrate_rgbd_sequence`` and the CLI on ``.npy`` depth files.
"""

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from deepglobalregistration_tpu.utils import integration as jint
from deepglobalregistration_tpu_torch.utils import integration as pint

H, W = 48, 64
K = np.array([[50.0, 0, W / 2], [0, 50.0, H / 2], [0, 0, 1]])
WALL = dict(origin=np.array([-1.0, -1.0, 0.5], np.float32), voxel_size=0.02,
            dims=(100, 100, 50), sdf_trunc=0.06)


def _assert_same(jvol, pvol):
    np.testing.assert_array_equal(pvol.tsdf.numpy(), jvol.tsdf)
    np.testing.assert_array_equal(pvol.weight.numpy(), jvol.weight)
    a, b = jvol.extract_point_cloud(), pvol.extract_point_cloud()
    assert b.dtype == np.float32 and b.shape == a.shape
    np.testing.assert_array_equal(b, a)
    return b


def _sequence(rng, n):
    """n frames of noisy depth around 1-1.2 m with holes, and camera->world
    poses a little off identity."""
    frames = []
    for _ in range(n):
        depth = (1.0 + 0.2 * rng.rand(H, W)).astype(np.float32)
        depth[rng.rand(H, W) < 0.1] = 0
        pose = np.eye(4)
        pose[:3, :3] = Rotation.from_euler("xyz", rng.randn(3) * 0.1).as_matrix()
        pose[:3, 3] = rng.randn(3) * 0.1
        frames.append((depth, pose))
    return frames


def test_flat_wall_matches_jax_bit_for_bit():
    jvol = jint.TSDFVolume(**WALL)
    pvol = pint.TSDFVolume(**WALL, device="cpu")
    depth = np.full((H, W), 1.0, np.float32)
    for _ in range(3):
        jvol.integrate(depth, K, np.eye(4))
        pvol.integrate(depth, K, np.eye(4))
    pts = _assert_same(jvol, pvol)
    assert len(pts) > 100 and np.abs(pts[:, 2] - 1.0).max() < 0.05


@pytest.mark.parametrize("slab_voxels", [1 << 22, 30000])
def test_moving_sequence_matches_jax_bit_for_bit(slab_voxels, monkeypatch):
    monkeypatch.setattr(pint, "SLAB_VOXELS", slab_voxels)  # one slab, or 17
    rng = np.random.RandomState(0)
    jvol = jint.TSDFVolume(**WALL)
    pvol = pint.TSDFVolume(**WALL, device="cpu")
    for depth, pose in _sequence(rng, 4):
        E = np.linalg.inv(pose)
        jvol.integrate(depth, K, E)
        pvol.integrate(depth, K, E)
    assert (jvol.weight > 0).sum() > 50000
    assert len(_assert_same(jvol, pvol)) > 1000


def _write_sequence(tmp_path, frames):
    ddir = tmp_path / "depth"
    ddir.mkdir()
    for i, (depth, _) in enumerate(frames):
        np.save(ddir / f"{i:03d}.npy", depth)
    poses = np.stack([p for _, p in frames])
    np.savez(tmp_path / "poses.npz", poses=poses)
    np.save(tmp_path / "K.npy", K)
    return ddir, poses


def test_rgbd_sequence_and_cli_match_jax(tmp_path):
    frames = _sequence(np.random.RandomState(1), 3)
    ddir, poses = _write_sequence(tmp_path, frames)
    files = sorted(ddir.iterdir())
    kw = dict(voxel_size=0.05, bbox_min=(-1, -1, 0.5), bbox_max=(1, 1, 1.5))
    want = jint.integrate_rgbd_sequence(files, K, poses, **kw)
    got = pint.integrate_rgbd_sequence(files, K, poses, device="cpu", **kw)
    assert len(want) > 100
    np.testing.assert_array_equal(got, want)

    # The CLI over the tool's default 6 x 6 x 4 m box.
    out = tmp_path / "frag.npz"
    pcd = pint.main(["--depth_dir", str(ddir), "--pose_file", str(tmp_path / "poses.npz"),
                     "--intrinsics", str(tmp_path / "K.npy"), "--voxel_size", "0.1",
                     "--out", str(out), "--device", "cpu"])
    want = jint.integrate_rgbd_sequence(files, K, poses, voxel_size=0.1)
    assert len(want) > 10
    np.testing.assert_array_equal(np.load(out)["pcd"], want)
    np.testing.assert_array_equal(pcd, want)


def test_empty_depth_yields_no_surface():
    vol = pint.TSDFVolume(origin=np.zeros(3, np.float32), voxel_size=0.05,
                          dims=(20, 20, 20), sdf_trunc=0.1, device="cpu")
    vol.integrate(np.zeros((H, W), np.float32), K, np.eye(4))
    pts = vol.extract_point_cloud()
    assert pts.shape == (0, 3) and pts.dtype == np.float32
    assert float(vol.weight.sum()) == 0.0


def test_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pint.TSDFVolume(**WALL)
