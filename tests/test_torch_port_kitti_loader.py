"""Port vs JAX package: the KITTI loaders, on the fixture of tests/test_kitti_loader.py.

The ground-truth ICP (the port's full scan, its plain version on the CPU)
against the JAX one: pose atol 1e-4, not the iteration count (the scan's
stop is rounding-driven at LiDAR ranges in both packages). With a shared
cache file both packages' items and pair lists are equal, and a cache
written by either reads in the other. With loader workers, ``prepare_gt``
fills the cache in the parent before they start, and a worker that finds no
cached pose raises instead of running the ICP.
"""

import os

import numpy as np
import pytest
import torch.utils.data

from deepglobalregistration_tpu.config import default_config as jax_config
from deepglobalregistration_tpu.data import kitti as jkitti
from deepglobalregistration_tpu_torch.config import default_config
from deepglobalregistration_tpu_torch.data import factory, kitti
from test_kitti_loader import DRIVE, TR, _pose, _write_drive

KEYS = ["%d_0_2" % DRIVE, "%d_3_5" % DRIVE]  # KITTIPairDataset's pairs
OVER = dict(kitti_max_time_diff=3, voxel_size=0.3,
            positive_pair_search_voxel_size_multiplier=1.5)


def _clear_caches():
    for mod in (kitti, jkitti):
        mod._kitti_cache.clear()
        mod._kitti_icp_cache.clear()


@pytest.fixture
def kitti_root(tmp_path, rng):
    """One drive, scans {0, 2, 3, 5} at poses 4 m apart along x: each scan is
    scan 0 re-expressed in the velo frame of its odometry pose, so the
    chained pose is exact. KITTIPairDataset pairs (0, 2) and (3, 5);
    KITTINMPairDataset (0, 2), 8 m apart (tests/test_kitti_loader.py's
    index quirk)."""
    root = tmp_path / "kitti"
    xyz0 = ((rng.rand(1500, 3) - 0.5) * np.array([40.0, 20.0, 4.0])).astype(np.float64)
    poses = [_pose(1.0 * t, (4.0 * t, 0.2 * t, 0.0)) for t in range(6)]
    clouds = {}
    for t in (0, 2, 3, 5):
        M = np.linalg.inv(TR) @ np.linalg.inv(poses[t]) @ poses[0] @ TR
        clouds[t] = xyz0 @ M[:3, :3].T + M[:3, 3]
    _write_drive(root, DRIVE, clouds, poses)
    split = tmp_path / "split_kitti.txt"
    split.write_text("%d\n" % DRIVE)
    _clear_caches()
    yield root, split
    _clear_caches()


def _datasets(cls_name, root, split, cache, port_cache=None, **over):
    """(port dataset, JAX dataset) of class ``cls_name`` over the fixture."""
    out = []
    for mod, make, path in ((kitti, default_config, port_cache or cache),
                            (jkitti, jax_config, cache)):
        base = getattr(mod, cls_name)
        cls = type(base.__name__, (base,),
                   {"DATA_FILES": dict(base.DATA_FILES, train=str(split))})
        extra = {"device": "cpu"} if mod is kitti else {}
        cfg = make(kitti_dir=str(root), icp_cache_path=str(path), **OVER, **extra,
                   **over)
        out.append(cls("train", random_scale=False, config=cfg))
    return out


def test_icp_refine_matches_jax(kitti_root, tmp_path):
    """The refinement's inputs from an odometry pose 0.5 deg and 5 cm off:
    the port's pose within 1e-4 of the JAX one."""
    root, split = kitti_root
    ds, _ = _datasets("KITTIPairDataset", root, split, tmp_path / "icp")
    xyz0, xyz1, positions = ds.load_scans(0)
    off = _pose(0.5, (0.05, 0.0, 0.0))
    M, src, tgt = ds.icp_inputs(xyz0, xyz1, [positions[0] @ off, positions[1]])
    res = kitti._icp_refine(src, tgt, device="cpu")
    T = res.T.double().numpy()
    T_jax = jkitti._icp_refine(src, tgt)
    np.testing.assert_allclose(T, T_jax, atol=1e-4)
    assert 1 < res.iterations <= 200


def test_icp_refine_raises_without_a_card_by_default(kitti_root, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src = np.zeros((10, 3), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        kitti._icp_refine(src, src)


@pytest.mark.parametrize("cls_name", ["KITTIPairDataset", "KITTINMPairDataset"])
def test_items_and_pairs_equal_with_a_shared_cache(kitti_root, tmp_path, cls_name):
    root, split = kitti_root
    ds, jds = _datasets(cls_name, root, split, tmp_path / "icp")
    assert ds.files == jds.files
    assert len(ds.files) >= 1
    for k, key in enumerate(ds.files):  # the shared cache: the chained poses
        np.save(os.path.join(ds.icp_path, "%d_%d_%d.npy" % key),
                ds.icp_inputs(*ds.load_scans(k))[0])
    for k in range(len(ds)):
        jitem, item = jds[k], ds[k]
        assert ds.gt_log == []
        for a, b in zip(item[:8], jitem[:8]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert item[8] == jitem[8]


def test_cache_reads_across_packages(kitti_root, tmp_path):
    """A cache written by either package reads in the other, in the JAX
    package's format (%d_%d_%d.npy, float64 4x4)."""
    root, split = kitti_root
    ds, jds = _datasets("KITTIPairDataset", root, split, tmp_path / "jax_icp",
                        port_cache=tmp_path / "port_icp")
    ds.prepare_gt()
    assert sorted(r["key"] for r in ds.gt_log) == KEYS
    _clear_caches()
    jitems = [jds[k] for k in range(len(jds))]
    for key in KEYS:
        a = np.load(tmp_path / "port_icp" / f"{key}.npy")
        b = np.load(tmp_path / "jax_icp" / f"{key}.npy")
        assert a.dtype == b.dtype == np.float64 and a.shape == (4, 4)
        np.testing.assert_allclose(a, b, atol=1e-4)
    # Swap the directories: each package reads the other's file.
    _clear_caches()
    ds.icp_path, jds.icp_path = jds.icp_path, ds.icp_path
    for k, jitem in enumerate(jitems):
        np.testing.assert_array_equal(ds[k][7], jitem[7])
        np.testing.assert_array_equal(
            jds[k][7], np.load(os.path.join(jds.icp_path, "%d_%d_%d.npy" % ds.files[k])
                               ).astype(np.float32))
    assert len(ds.gt_log) == 2  # the reads ran no ICP


def test_min_matches_raise_alike(tmp_path, rng):
    root = tmp_path / "kitti"
    xyz0 = (rng.rand(800, 3) * 10).astype(np.float64)
    _write_drive(root, DRIVE, {0: xyz0, 2: xyz0 + np.array([500.0, 0.0, 0.0])},
                 [np.eye(4)] * 3)
    split = tmp_path / "split_kitti.txt"
    split.write_text("%d\n" % DRIVE)
    _clear_caches()
    for d in _datasets("KITTIPairDataset", root, split, tmp_path / "icp"):
        with pytest.raises(ValueError, match="Insufficient matches"):
            d[0]
    _clear_caches()


def test_workers_read_what_the_parent_prepared(kitti_root, tmp_path, monkeypatch):
    """make_data_loader with two workers computes every pose first, in this
    process; the workers' batches carry those poses."""
    root, split = kitti_root
    cfg = default_config(kitti_dir=str(root), icp_cache_path=str(tmp_path / "icp"),
                         dataset="KITTIPairDataset", device="cpu", **OVER)
    base = kitti.KITTIPairDataset
    sub = type(base.__name__, (base,), {"DATA_FILES": dict(base.DATA_FILES, test=str(split))})
    monkeypatch.setitem(factory.dataset_str_mapping, "KITTIPairDataset", sub)
    loader = factory.make_data_loader(cfg, "test", batch_size=1, num_workers=2,
                                      shuffle=False)
    loader.timeout = 120  # a worker that hangs fails the test
    ds = loader.dataset
    assert sorted(r["key"] for r in ds.gt_log) == KEYS
    assert sorted(os.listdir(tmp_path / "icp")) == [k + ".npy" for k in KEYS]
    batches = list(loader)
    assert len(batches) == 2
    for b, (drive, t0, t1) in zip(batches, ds.files):
        want = np.load(tmp_path / "icp" / ("%d_%d_%d.npy" % (drive, t0, t1)))
        np.testing.assert_array_equal(b["T_gt"][0], want.astype(np.float32))


def test_worker_without_a_cached_pose_raises(kitti_root, tmp_path):
    root, split = kitti_root
    ds, _ = _datasets("KITTIPairDataset", root, split, tmp_path / "icp")
    loader = torch.utils.data.DataLoader(ds, batch_size=1, num_workers=2,
                                         collate_fn=lambda x: x, timeout=120)
    with pytest.raises(RuntimeError, match="does not run the ICP"):
        list(loader)
    assert os.listdir(tmp_path / "icp") == [] and ds.gt_log == []
