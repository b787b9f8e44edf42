"""Port vs JAX package: the data layer the evaluation entry points read.

File and PLY I/O, GT matching, the native host engine's binding, the
augmentation, every dataset's items, collation and the loader factory. The
port's modules are copies (numpy on the host), so everything is held to
equality: integer arrays exactly, float arrays bit for bit. The indoor
dataset draws its scale from Python's ``random`` and its rotations from its
own ``RandomState``, so both are seeded alike before each item, for each
package.
"""

import filecmp
import random

import numpy as np
import pytest

from deepglobalregistration_tpu import native as jnative
from deepglobalregistration_tpu.config import default_config as jax_config
from deepglobalregistration_tpu.data import base as jbase
from deepglobalregistration_tpu.data import collate as jcollate
from deepglobalregistration_tpu.data import factory as jfactory
from deepglobalregistration_tpu.data import synthetic as jsynthetic
from deepglobalregistration_tpu.data import threedmatch as jthreedmatch
from deepglobalregistration_tpu.data import transforms as jtransforms
from deepglobalregistration_tpu.ops import kernel_map as jkernel_map
from deepglobalregistration_tpu.utils import file as jfile
from deepglobalregistration_tpu.utils import pointcloud as jpc
from deepglobalregistration_tpu.utils import timer as jtimer
from deepglobalregistration_tpu_torch import native
from deepglobalregistration_tpu_torch.config import default_config
from deepglobalregistration_tpu_torch.data import base, collate, factory, synthetic
from deepglobalregistration_tpu_torch.data import threedmatch, transforms
from deepglobalregistration_tpu_torch.utils import file, pointcloud, timer

SCENE = "sun3d-home_at-home_at_scan1_2013_jan_1"


def _assert_items_equal(a, b):
    """Two dataset items (tuples of arrays, dicts, strings) equal bit for bit."""
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray):
            assert x.dtype == np.asarray(y).dtype and x.shape == np.shape(y)
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y


@pytest.mark.parametrize("name", ["train_3dmatch.txt", "val_3dmatch.txt",
                                  "test_3dmatch.txt", "train_kitti.txt",
                                  "val_kitti.txt", "test_kitti.txt"])
def test_split_files_are_byte_identical(name):
    assert filecmp.cmp(base.SPLIT_DIR / name, jbase.SPLIT_DIR / name, shallow=False)


def test_trajectory_round_trip_both_ways(tmp_path, rng):
    traj = [file.CameraPose(meta=[i, i + 1, 5], pose=rng.randn(4, 4)) for i in range(3)]
    file.write_trajectory(traj, tmp_path / "port.log")
    jfile.write_trajectory(traj, tmp_path / "jax.log")
    assert filecmp.cmp(tmp_path / "port.log", tmp_path / "jax.log", shallow=False)
    for a, b in zip(file.read_trajectory(tmp_path / "jax.log"),
                    jfile.read_trajectory(tmp_path / "port.log")):
        assert a.meta == b.meta
        np.testing.assert_array_equal(a.pose, b.pose)
    (tmp_path / "d").mkdir()
    for n in ("b10.ply", "b9.ply", "a.txt"):
        (tmp_path / "d" / n).write_text("")
    assert file.get_file_list(tmp_path / "d", ".ply") == jfile.get_file_list(
        tmp_path / "d", ".ply")
    assert file.sorted_alphanum(["x10", "x9", "x1"]) == ["x1", "x9", "x10"]


def test_ply_round_trip_both_ways(tmp_path, rng):
    xyz = rng.randn(300, 3).astype(np.float32)
    pointcloud.write_point_cloud(tmp_path / "port.ply", xyz)
    jpc.write_point_cloud(tmp_path / "jax.ply", xyz)
    assert filecmp.cmp(tmp_path / "port.ply", tmp_path / "jax.ply", shallow=False)
    np.testing.assert_array_equal(pointcloud.read_point_cloud(tmp_path / "jax.ply"), xyz)
    np.testing.assert_array_equal(jpc.read_point_cloud(tmp_path / "port.ply"), xyz)
    # An ascii PLY with an extra property, read alike.
    body = "\n".join(f"{a} {b} {c} 7" for a, b, c in xyz[:5])
    (tmp_path / "a.ply").write_text(
        "ply\nformat ascii 1.0\nelement vertex 5\nproperty float x\nproperty "
        "float y\nproperty float z\nproperty uchar k\nend_header\n" + body + "\n")
    np.testing.assert_array_equal(pointcloud.read_point_cloud(tmp_path / "a.ply"),
                                  jpc.read_point_cloud(tmp_path / "a.ply"))


def test_matching_overlap_and_feature_hits_equal(rng):
    src = (rng.rand(400, 3) * 2).astype(np.float32)
    tgt = (rng.rand(500, 3) * 2).astype(np.float32)
    T = np.eye(4)
    T[:3, 3] = [0.05, -0.02, 0.01]
    for K in (None, 1):
        np.testing.assert_array_equal(
            pointcloud.get_matching_indices(src, tgt, T, 0.08, K),
            jpc.get_matching_indices(src, tgt, T, 0.08, K))
    assert pointcloud.compute_overlap_ratio(src, tgt, T, 0.05) == \
        jpc.compute_overlap_ratio(src, tgt, T, 0.05)
    f0, f1 = rng.randn(400, 8), rng.randn(500, 8)
    assert pointcloud.evaluate_feature_3dmatch(src, tgt, f0, f1, T) == \
        jpc.evaluate_feature_3dmatch(src, tgt, f0, f1, T)
    np.testing.assert_array_equal(pointcloud.apply_transform_np(src, T),
                                  jpc.apply_transform_np(src, T))


@pytest.mark.parametrize("span", [5, 200])
def test_native_unique_rows_and_voxelize_exact(rng, span):
    """The port's library, the JAX package's and the plain numpy versions
    agree bit for bit (dense duplicates at span 5, sparse at 200)."""
    coords = rng.randint(-span, span, size=(3000, 3)).astype(np.int32)
    for a, b, c in zip(native.unique_rows(coords), jnative.unique_rows(coords),
                       native.unique_rows_plain(coords)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
        assert a.dtype == np.int32
    xyz = (rng.randn(4000, 3) * span * 0.01).astype(np.float32)
    for a, b, c in zip(native.voxelize(xyz, 0.05), jnative.voxelize(xyz, 0.05),
                       native.voxelize_plain(xyz, 0.05)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("transpose", [False, True])
def test_native_kernel_map_exact(rng, transpose):
    coords = np.unique(rng.randint(-6, 6, size=(150, 3)).astype(np.int32), axis=0)
    offs = jkernel_map.kernel_offsets(3, 3)
    got = native.kernel_map(coords, coords[::2], offs, unit=2, transpose=transpose)
    np.testing.assert_array_equal(
        got, jnative.kernel_map(coords, coords[::2], offs, unit=2, transpose=transpose))
    np.testing.assert_array_equal(
        got, native.kernel_map_plain(coords, coords[::2], offs, unit=2,
                                     transpose=transpose))


def test_native_radius_pairs(rng):
    """Against the JAX binding exactly, in the order given; against the
    plain KD-tree version as sorted sets (their orders differ)."""
    src = (rng.rand(600, 3) * 2).astype(np.float32)
    tgt = (rng.rand(700, 3) * 2).astype(np.float32)
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [0.05, -0.02, 0.01]
    got = native.radius_pairs(src, tgt, T, 0.08)
    np.testing.assert_array_equal(got, jnative.radius_pairs(src, tgt, T, 0.08))
    plain = native.radius_pairs_plain(src, tgt, T, 0.08)
    assert len(got) > 100
    assert sorted(map(tuple, got)) == sorted(map(tuple, plain))
    assert len(native.radius_pairs(src, tgt, T, 0.08, max_pairs=10)) == 10


def test_native_rejects_bad_shapes():
    with pytest.raises(ValueError):
        native.voxelize(np.zeros((4, 2), np.float32), 0.1)
    with pytest.raises(ValueError):
        native.unique_rows(np.zeros((4, 9), np.int32))


def test_transforms_equal(rng):
    pcd = rng.rand(100, 3)
    for rot in (360.0, np.pi / 4):
        a = transforms.sample_random_trans(pcd, np.random.RandomState(3), rot)
        b = jtransforms.sample_random_trans(pcd, np.random.RandomState(3), rot)
        np.testing.assert_array_equal(a, b)
    feats = np.ones((50, 1), np.float32)
    a = transforms.Compose([transforms.Jitter(randg=np.random.RandomState(1))])(pcd, feats)
    b = jtransforms.Compose([jtransforms.Jitter(randg=np.random.RandomState(1))])(pcd, feats)
    np.testing.assert_array_equal(a[1], b[1])


def test_timer_and_meter_agree():
    m, jm = timer.AverageMeter(), jtimer.AverageMeter()
    for v, n in ((1.0, 1), (3.0, 2), (0.5, 4)):
        m.update(v, n)
        jm.update(v, n)
    assert (m.avg, m.sum, m.count, m.var) == (jm.avg, jm.sum, jm.count, jm.var)
    t = timer.Timer()
    for _ in range(2):
        t.tic()
        diff = t.toc(average=False)
    assert t.calls == 2 and diff >= 0.0 and t.avg == t.total_time / 2


@pytest.fixture
def threedmatch_root(tmp_path, rng):
    """The layout of tests/test_data.py: npz fragments + an overlap list."""
    root = tmp_path / "threedmatch"
    root.mkdir()
    for i in range(3):
        np.savez(root / f"{SCENE}@seq-01_{i:03d}.npz",
                 pcd=(rng.rand(500, 3) * 2).astype(np.float32))
    (root / f"{SCENE}@seq-01-0.30.txt").write_text(
        f"{SCENE}@seq-01_000.npz {SCENE}@seq-01_001.npz 0.7\n"
        f"{SCENE}@seq-01_001.npz {SCENE}@seq-01_002.npz 0.6\n")
    split = tmp_path / "split.txt"
    split.write_text(SCENE + "\n")
    return root, split


def _with_split(cls, split):
    return type(cls.__name__, (cls,), {"DATA_FILES": dict(cls.DATA_FILES, train=str(split))})


@pytest.mark.parametrize("xyz_feature", [False, True])
def test_threedmatch_pair_dataset_items_equal(threedmatch_root, xyz_feature):
    root, split = threedmatch_root
    over = dict(threed_match_dir=str(root), voxel_size=0.05,
                use_xyz_feature=xyz_feature)
    ds = _with_split(threedmatch.ThreeDMatchPairDataset03, split)(
        "train", random_rotation=True, random_scale=True,
        config=default_config(**over))
    jds = _with_split(jthreedmatch.ThreeDMatchPairDataset03, split)(
        "train", random_rotation=True, random_scale=True, config=jax_config(**over))
    assert ds.files == jds.files and len(ds) == 2
    for k in range(len(ds)):
        items = []
        for d in (ds, jds):
            random.seed(k)
            d.reset_seed(k)
            items.append(d[k])
        _assert_items_equal(*items)
        assert len(items[0][6]) > 0


@pytest.mark.parametrize("cls_name,phase,over", [
    ("SyntheticPairDataset", "train", dict(voxel_size=0.05)),
    ("SyntheticPairDataset", "val", dict(voxel_size=0.05)),
    ("SyntheticLidarPairDataset", "train", dict(voxel_size=0.3,
                                                use_random_scale=True)),
])
def test_synthetic_pair_dataset_items_equal(cls_name, phase, over):
    cfg = dict(synthetic_points=1500, **over)
    rot = phase == "train"
    ds = getattr(synthetic, cls_name)(phase, random_rotation=rot, random_scale=rot,
                                      config=default_config(**cfg))
    jds = getattr(jsynthetic, cls_name)(phase, random_rotation=rot, random_scale=rot,
                                        config=jax_config(**cfg))
    assert ds.files == jds.files
    for k in (0, 7):
        _assert_items_equal(ds[k], jds[k])


def test_synthetic_trajectory_dataset_items_equal():
    ds = synthetic.SyntheticTrajectoryDataset(n_points=1500, n_scenes=2,
                                              pairs_per_scene=2)
    jds = jsynthetic.SyntheticTrajectoryDataset(n_points=1500, n_scenes=2,
                                                pairs_per_scene=2)
    assert ds.files == jds.files
    for k in range(len(ds)):
        _assert_items_equal(ds[k], jds[k])


def _synthetic_items(n=3):
    ds = synthetic.SyntheticPairDataset(
        "val", random_rotation=False, random_scale=False,
        config=default_config(synthetic_points=1500, voxel_size=0.05))
    return [ds[k] for k in range(n)]


def test_make_pair_batch_and_collate_equal():
    items = _synthetic_items()
    pb, jpb = collate.make_pair_batch(items), jcollate.make_pair_batch(items)
    assert pb._fields == jpb._fields
    _assert_items_equal(tuple(pb), tuple(np.asarray(a) for a in jpb))
    assert collate.bucket_for(3000) == jcollate.bucket_for(3000) == 4096
    got = collate.CollationFunctionFactory(collation_type="collate_pair")(items)
    want = jcollate.CollationFunctionFactory(collation_type="collate_pair")(items)
    assert got.keys() == want.keys()
    for key in got:
        if key == "pair_batch":
            _assert_items_equal(tuple(got[key]), tuple(np.asarray(a) for a in want[key]))
        elif key in ("pcd0", "pcd1", "correspondences", "T_gt"):
            _assert_items_equal(tuple(got[key]), tuple(want[key]))
        else:
            assert got[key] == want[key]


def test_make_data_loader_same_batches():
    over = dict(dataset="SyntheticPairDataset", synthetic_points=1500, voxel_size=0.05)
    loader = factory.make_data_loader(default_config(**over), "val", batch_size=2,
                                      shuffle=False)
    jloader = jfactory.make_data_loader(jax_config(**over), "val", batch_size=2,
                                        shuffle=False)
    assert sorted(factory.dataset_str_mapping) == sorted(jfactory.dataset_str_mapping)
    for _, batch, jbatch in zip(range(2), loader, jloader):
        _assert_items_equal(tuple(batch["pair_batch"]),
                            tuple(np.asarray(a) for a in jbatch["pair_batch"]))
        assert batch["len_batch"] == jbatch["len_batch"]


def _labels_both(items, rng, q=256):
    """(the port's batch, ``q`` predicted pairs a pair, half of them the
    pair's own matches, and their labels by the port, the JAX package and
    the reference's host formulation on the whole match list)."""
    import jax
    import torch

    from deepglobalregistration_tpu.core import correspondence as jcorr
    from deepglobalregistration_tpu_torch.core import correspondence

    pred = np.zeros((len(items), q, 2), np.int32)
    for b, item in enumerate(items):
        m = np.asarray(item[6])
        pred[b, :q // 2] = m[rng.randint(0, len(m), q // 2)]
        pred[b, q // 2:] = np.stack([rng.randint(0, len(item[0]), q // 2),
                                     rng.randint(0, len(item[1]), q // 2)], 1)
    pred_num = np.full(len(items), q, np.int32)
    pb, jpb = collate.make_pair_batch(items), jcollate.make_pair_batch(items)
    got = correspondence.find_correct_correspondence(
        torch.as_tensor(pb.pos_pairs), pb.pos_num, torch.as_tensor(pred), pred_num)
    want = jax.vmap(jcorr.find_correct_correspondence)(
        jpb.pos_pairs, jpb.pos_num, pred, pred_num)
    exact = np.stack([correspondence.find_correct_correspondence_np(np.asarray(it[6]), p)
                      for it, p in zip(items, pred)])
    return pb, pred, got.numpy(), np.asarray(want), exact


def test_labels_below_the_cap_equal_the_jax_labels():
    pb, _, got, want, exact = _labels_both(_synthetic_items(),
                                           np.random.RandomState(0))
    assert pb.pos_pairs.shape[1] <= 131072
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, exact)
    assert got.any() and not got.all()


def test_labels_above_the_cap_keep_every_match():
    """400 x 400 points, every pair a match (160000 > 131072): the port
    keeps them all and labels every predicted pair positive; the JAX package
    keeps the first 131072 matches (row-major) and labels the rest negative."""
    rng = np.random.RandomState(1)
    xyz = rng.rand(400, 3).astype(np.float32)
    coords = np.floor(xyz / 0.05).astype(np.int32)
    ii, jj = np.meshgrid(np.arange(400), np.arange(400), indexing="ij")
    matches = np.stack([ii.ravel(), jj.ravel()], 1).astype(np.int32)
    ones = np.ones((400, 1), np.float32)
    item = (xyz, xyz, coords, coords, ones, ones, matches, np.eye(4, dtype=np.float32),
            {})
    pb, pred, got, want, exact = _labels_both([item], rng)
    assert int(pb.pos_num[0]) == len(matches) == pb.pos_pairs.shape[1]
    np.testing.assert_array_equal(got, exact)
    assert got.all()
    np.testing.assert_array_equal(want, pred[..., 0] * 400 + pred[..., 1] < 131072)
    assert not want.all()
