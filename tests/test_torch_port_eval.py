"""Port vs JAX package: the evaluation entry points, the whole slice.

3DMatch: a two-pair fixture in the benchmark's layout (binary PLY fragments,
``<scene>-evaluation/gt.log`` with poses inv(T_gt)) at the configuration of
tests/test_torch_port_pipeline.py, both nets carried from the JAX instance.
The port's ``evaluate`` against the JAX script's: equal success columns and
scene ids; rte and rre within what that file's atol 1e-3 on T implies
(|dt| <= sqrt(3) 1e-3 m, so 2e-3 m; |dR| <= 1e-3 an entry, so at most
||dR||_F / sqrt(2) = 2.2e-3 rad, 0.13 deg); the npz reads in
``scripts/analyze_stats``. KITTI: ``evaluate`` with an oracle method over the
synthetic LiDAR loader gives the JAX script's stats but the time column.
The demo runs on the CPU when asked; the three entry points raise without a
card otherwise.
"""

import numpy as np
import pytest
import torch
import torch.utils.data

from deepglobalregistration_tpu.config import default_config as jax_config
from deepglobalregistration_tpu.core.pipeline import DeepGlobalRegistration as JaxDGR
from deepglobalregistration_tpu.data.factory import make_data_loader as jax_loader
from deepglobalregistration_tpu.data.threedmatch import (
    ThreeDMatchTrajectoryDataset as JaxTrajectory)
from deepglobalregistration_tpu_torch import demo
from deepglobalregistration_tpu_torch.config import default_config
from deepglobalregistration_tpu_torch.core.pipeline import DeepGlobalRegistration
from deepglobalregistration_tpu_torch.data.factory import make_data_loader
from deepglobalregistration_tpu_torch.data.threedmatch import ThreeDMatchTrajectoryDataset
from deepglobalregistration_tpu_torch.scripts import test_3dmatch, test_kitti
from deepglobalregistration_tpu_torch.utils.convert import from_jax_params
from deepglobalregistration_tpu_torch.utils.file import CameraPose, write_trajectory
from deepglobalregistration_tpu_torch.utils.pointcloud import write_point_cloud
from deepglobalregistration_tpu_torch.utils.synthetic import synthetic_pair
from scripts import analyze_stats
from scripts import test_3dmatch as jax_3dmatch
from scripts import test_kitti as jax_kitti

CFG = dict(feat_model="ResUNetBN2F", feat_model_n_out=8, feat_conv1_kernel_size=3,
           inlier_model="ResUNetBN2FX", inlier_conv1_kernel_size=3,
           voxel_size=0.05, inlier_feature_type="ones",
           point_buckets="512,1024", ransac_hypotheses=512, level_shrink=1)
SCENE = "7-scenes-redkitchen"  # scene 0 of the test split


@pytest.fixture(scope="module")
def pair_of_pipelines():
    jdgr = JaxDGR(jax_config(**CFG))
    dgr = DeepGlobalRegistration(default_config(**CFG), device="cpu")
    dgr.fcgf.load_state_dict(from_jax_params(jdgr.fcgf_params, jdgr.fcgf_state,
                                             jdgr.fcgf_cfg))
    dgr.inlier.load_state_dict(from_jax_params(jdgr.inlier_params,
                                               jdgr.inlier_state, jdgr.inlier_cfg))
    return jdgr, dgr


@pytest.fixture(scope="module")
def threedmatch_root(tmp_path_factory):
    """Fragments 0 (a 400-point cloud), 1 (shifted) and 2 (turned 0.1 rad
    about z, shuffled, cut to 380 points); pairs (0, 1) and (0, 2)."""
    root = tmp_path_factory.mktemp("3dmatch")
    rng = np.random.RandomState(0)
    xyz = (rng.rand(400, 3) * 1.2).astype(np.float32)
    c, s = np.cos(0.1), np.sin(0.1)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    T1, T2 = np.eye(4), np.eye(4)
    T1[:3, 3] = np.array([8, -8, 16], np.float32) * 0.05
    T2[:3, :3], T2[:3, 3] = R, 0.02
    clouds = [xyz, xyz + T1[:3, 3].astype(np.float32),
              (xyz @ R.T + 0.02)[rng.permutation(400)][:380].astype(np.float32)]
    (root / SCENE).mkdir()
    (root / f"{SCENE}-evaluation").mkdir()
    for k, cloud in enumerate(clouds):
        write_point_cloud(root / SCENE / f"cloud_bin_{k}.ply", cloud)
    write_trajectory([CameraPose([0, 1, 3], np.linalg.inv(T1)),
                      CameraPose([0, 2, 3], np.linalg.inv(T2))],
                     root / f"{SCENE}-evaluation" / "gt.log")
    return root


def _loader(cls, config):
    dset = cls(phase="test", random_scale=False, random_rotation=False,
               scene_id=0, config=config)
    return torch.utils.data.DataLoader(dset, batch_size=1, shuffle=False,
                                       collate_fn=lambda x: x)


def test_3dmatch_evaluate_matches_jax(pair_of_pipelines, threedmatch_root, tmp_path):
    jdgr, dgr = pair_of_pipelines
    over = dict(threed_match_dir=str(threedmatch_root))
    cfg = default_config(out_dir=str(tmp_path / "port"), **over)
    stats = test_3dmatch.evaluate([dgr], ["port"], _loader(ThreeDMatchTrajectoryDataset,
                                                            cfg), cfg)
    jcfg = jax_config(out_dir=str(tmp_path / "jax"), **over)
    jstats = jax_3dmatch.evaluate([jdgr], ["jax"], _loader(JaxTrajectory, jcfg), jcfg)
    assert stats.shape == jstats.shape == (1, 2, 5)
    np.testing.assert_array_equal(stats[..., 0], jstats[..., 0])  # success
    np.testing.assert_array_equal(stats[..., 4], jstats[..., 4])  # scene id
    assert stats[..., 0].all()
    np.testing.assert_allclose(stats[..., 1], jstats[..., 1], atol=2e-3)  # rte, m
    np.testing.assert_allclose(stats[..., 2], jstats[..., 2], atol=0.13)  # rre, deg
    assert (stats[..., 3] > 0).all()

    saved = np.load(tmp_path / "port" / "3dmatch-stats.npz")
    np.testing.assert_array_equal(saved["stats"], stats)
    analyze_stats.summarize(saved["stats"], saved["names"])
    _, _, curves = analyze_stats.recall_curves(saved["stats"], saved["names"])
    assert curves["port"][0][-1] == 1.0


class _Oracle:
    """Returns each pair's ground truth, moved 1 m on every third pair."""

    def __init__(self, truths):
        self.truths = list(truths)
        self.calls = 0

    def register(self, xyz0, xyz1):
        T = np.array(self.truths[self.calls], np.float64)
        if self.calls % 3 == 2:
            T[:3, 3] += 1.0
        self.calls += 1
        return T


def test_kitti_evaluate_with_an_oracle_matches_jax(tmp_path):
    over = dict(dataset="SyntheticLidarPairDataset", synthetic_points=1000,
                voxel_size=0.3)
    cfg = default_config(out_dir=str(tmp_path / "port"), **over)
    jcfg = jax_config(out_dir=str(tmp_path / "jax"), **over)
    loader = make_data_loader(cfg, "test", batch_size=1, shuffle=False)
    jloader = jax_loader(jcfg, "test", batch_size=1, shuffle=False)
    truths = [loader.dataset[k][7] for k in range(len(loader.dataset))]
    stats = test_kitti.evaluate(cfg, loader, _Oracle(truths))
    jstats = jax_kitti.evaluate(jcfg, jloader, _Oracle(truths))
    assert stats.shape == (len(truths), 5)
    np.testing.assert_array_equal(np.delete(stats, 3, axis=1), np.delete(jstats, 3, axis=1))
    assert 0 < stats[:, 0].mean() < 1
    assert np.load(tmp_path / "port" / "kitti-stats.npz")["stats"].shape == (1,) + stats.shape


def test_demo_runs_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(demo, "synthetic_pair", lambda: synthetic_pair(n=3000))
    out = demo.main(["--device", "cpu"])
    printed = capsys.readouterr().out
    assert "RTE" in printed and "RRE" in printed
    assert out["T"].shape == (4, 4) and np.isfinite(out["T"]).all()
    assert np.isfinite([out["rte"], out["rre"]]).all()


@pytest.mark.parametrize("main", [demo.main, test_3dmatch.main, test_kitti.main],
                         ids=["demo", "test_3dmatch", "test_kitti"])
def test_entry_points_raise_without_a_card(monkeypatch, main):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        main([])
