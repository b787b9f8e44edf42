"""Port vs JAX package: candidate-list ICP, its checked fallback, and the
pipeline's choice of ICP mode.

The same numpy inputs go to both packages. ``_build_candidates`` is integer
work plus gathers, so its indices, coordinates and overflow flag must be
equal, including cells whose targets share a key (the stable sort keeps
them in ascending target index). ICP poses agree to atol 1e-5, as in
``tests/test_registration.py``: the candidate reduction and the full scan
take the same neighbours but sum in another order, so the o3d stop rule may
fire some iterations apart. The checked wrapper's fallback IS the full scan,
so its pose must equal the full scan's exactly.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from deepglobalregistration_tpu.config import default_config as jax_config
from deepglobalregistration_tpu.core.pipeline import DeepGlobalRegistration as JaxDGR
from deepglobalregistration_tpu.ops import icp as jicp
from deepglobalregistration_tpu_torch.config import default_config
from deepglobalregistration_tpu_torch.core.pipeline import DeepGlobalRegistration
from deepglobalregistration_tpu_torch.ops import icp

T_ = torch.from_numpy
CFG = dict(feat_model="ResUNetBN2F", feat_model_n_out=8, feat_conv1_kernel_size=3,
           inlier_model="ResUNetBN2FX", inlier_conv1_kernel_size=3,
           voxel_size=0.05, inlier_feature_type="ones",
           point_buckets="512,1024", ransac_hypotheses=512, level_shrink=1)


def _pad(a, cap):
    out = np.zeros((cap, 3), np.float32)
    out[:len(a)] = a
    return out


def _jax_candidates(moved0, target, cell, cap):
    """The JAX package's lists, with the target padded to ``cap`` rows."""
    fn = jax.jit(partial(jicp._build_candidates, cell=cell))
    idx, xyz, ov = fn(jnp.asarray(moved0), jnp.asarray(_pad(target, cap)),
                      jnp.int32(len(target)))
    return np.asarray(idx), np.asarray(xyz), bool(ov)


def _clouds(case, rng):
    if case == "random":
        src = (rng.rand(500, 3) * 2 - 0.5).astype(np.float32)
        tgt = (rng.rand(450, 3) * 2 - 0.5).astype(np.float32)
    elif case == "shared_keys":
        # 40 cells' worth of targets: many targets per cell key, exact
        # duplicates among them, and cells beyond the 8-slot cap.
        base = (rng.rand(40, 3) * 0.8).astype(np.float32)
        tgt = np.repeat(base, 6, axis=0) + (rng.rand(240, 3) * 0.05).astype(np.float32)
        tgt = np.concatenate([tgt, tgt[:30]])[rng.permutation(270)]
        src = (rng.rand(300, 3) * 0.9).astype(np.float32)
    else:  # lidar_range: coordinates of tens of metres, 0.6 m cells
        ang = rng.rand(800) * 2 * np.pi
        r = rng.rand(800) * 40 + 2
        tgt = np.stack([r * np.cos(ang), r * np.sin(ang), rng.rand(800) * 4],
                       1).astype(np.float32)
        src = (tgt + rng.randn(800, 3).astype(np.float32) * 0.1)[rng.permutation(800)]
    return src.astype(np.float32), tgt.astype(np.float32)


@pytest.mark.parametrize("case,cell", [("random", 0.1), ("shared_keys", 0.1),
                                       ("lidar_range", 0.6)])
def test_build_candidates_equal_jax(case, cell):
    src, tgt = _clouds(case, np.random.RandomState(len(case)))
    idx, xyz, ov = icp._build_candidates(T_(src), T_(tgt), cell=cell)
    j_idx, j_xyz, j_ov = _jax_candidates(src, tgt, cell, cap=len(tgt) + 37)
    assert idx.dtype == torch.int32 and idx.shape == (len(src), 216)
    np.testing.assert_array_equal(idx.numpy(), j_idx)
    np.testing.assert_array_equal(xyz.numpy(), j_xyz)
    assert ov == j_ov
    assert ov == (case == "shared_keys")
    assert (idx >= 0).any()


def test_join_equals_searchsorted_counts():
    """Each source cell's (start, count) run in the sorted target keys holds
    exactly the targets of that cell."""
    src, tgt = _clouds("shared_keys", np.random.RandomState(3))
    idx, _, _ = icp._build_candidates(T_(src), T_(tgt), cell=0.1, cap_per_cell=64)
    cells_t = np.floor(tgt / 0.1).astype(np.int64)
    cells_s = np.floor(src / 0.1).astype(np.int64)
    offs = np.stack(np.meshgrid(*[np.arange(-1, 2)] * 3, indexing="ij"), -1).reshape(27, 3)
    got = idx.numpy().reshape(len(src), 27, 64)
    for i in range(0, len(src), 17):
        for k in range(27):
            want = np.nonzero((cells_t == cells_s[i] + offs[k]).all(1))[0]
            row = got[i, k]
            np.testing.assert_array_equal(row[row >= 0], want)


def _near_converged(seed):
    rng = np.random.RandomState(seed)
    src = (rng.rand(600, 3) * 2).astype(np.float32)
    tgt = (src + np.float32([0.008, -0.005, 0.006])
           + 0.002 * rng.randn(600, 3)).astype(np.float32)
    return src, tgt


def _coarse(seed):
    rng = np.random.RandomState(seed)
    R = Rotation.from_euler("z", 20, degrees=True).as_matrix().astype(np.float32)
    t = np.float32([0.05, -0.03, 0.02])
    src = (rng.rand(500, 3) * 2).astype(np.float32)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3], T[:3, 3] = R, t
    return src, (src @ R.T + t).astype(np.float32), T


def _jax_icp(src, tgt, mcd, use_candidates):
    cap = 1024
    return jax.jit(lambda s, g: jicp.registration_icp(
        s, g, jnp.int32(len(src)), jnp.int32(len(tgt)),
        max_correspondence_distance=mcd, use_candidates=use_candidates))(
        jnp.asarray(_pad(src, cap)), jnp.asarray(_pad(tgt, cap)))


def test_candidates_match_full_scan_and_jax():
    """Candidate against full scan within each package, and each mode
    against its JAX counterpart. The full scan's stop iteration is held to
    nothing: its d2 is |a|^2 - 2a.b + |b|^2 in f32 in both packages, whose
    rounding here exceeds the 1e-6 rmse rule, so it stops where the pose
    happens to repeat bit for bit, which the order of the sums decides (on
    this input the JAX scan stops after 3 iterations, the port's plain
    scan after 4, both candidate paths after 2)."""
    src, tgt = _near_converged(0)
    full = icp.registration_icp(T_(src), T_(tgt), 0.1)
    cand = icp.registration_icp(T_(src), T_(tgt), 0.1, use_candidates=True)
    assert cand.cand_ok and full.cand_ok
    np.testing.assert_allclose(cand.T.numpy(), full.T.numpy(), atol=1e-5)
    np.testing.assert_allclose(cand.inlier_rmse, full.inlier_rmse, atol=1e-5)
    jfull = _jax_icp(src, tgt, 0.1, False)
    jcand = _jax_icp(src, tgt, 0.1, True)
    assert bool(jcand.cand_ok)
    np.testing.assert_allclose(cand.T.numpy(), np.asarray(jcand.T), atol=1e-5)
    assert abs(cand.iterations - int(jcand.iterations)) <= 1
    np.testing.assert_allclose(full.T.numpy(), np.asarray(jfull.T), atol=1e-5)
    assert 1 < full.iterations < 30 and 1 < int(jfull.iterations) < 30


def test_candidates_flag_large_drift():
    src, tgt, _ = _coarse(1)
    res = icp.registration_icp(T_(src), T_(tgt), 0.5, use_candidates=True)
    assert not res.cand_ok
    # The loop stops at the first iteration past the quarter-cell bound.
    assert res.iterations < 30
    assert not bool(_jax_icp(src, tgt, 0.5, True).cand_ok)


def test_checked_falls_back_to_the_full_scan():
    src, tgt, T_gt = _coarse(2)
    checked = icp.registration_icp_checked(T_(src), T_(tgt), 0.5)
    assert not checked.cand_ok
    full = icp.registration_icp(T_(src), T_(tgt), 0.5)
    np.testing.assert_array_equal(checked.T.numpy(), full.T.numpy())
    assert checked.iterations == full.iterations
    np.testing.assert_allclose(checked.T.numpy(), T_gt, atol=5e-3)
    jres = jax.jit(lambda s, g: jicp.registration_icp_checked(
        s, g, jnp.int32(500), jnp.int32(500), max_correspondence_distance=0.5))(
        jnp.asarray(_pad(src, 512)), jnp.asarray(_pad(tgt, 512)))
    np.testing.assert_allclose(checked.T.numpy(), np.asarray(jres.T), atol=1e-4)


def test_checked_keeps_the_candidate_answer_when_valid():
    src, tgt = _near_converged(3)
    checked = icp.registration_icp_checked(T_(src), T_(tgt), 0.1)
    cand = icp.registration_icp(T_(src), T_(tgt), 0.1, use_candidates=True)
    assert checked.cand_ok
    np.testing.assert_array_equal(checked.T.numpy(), cand.T.numpy())


@pytest.mark.parametrize("mode,want", [("auto", (False, True)), ("on", (True, True)),
                                       ("off", (False, False))])
def test_use_cand_for(mode, want):
    dgr = DeepGlobalRegistration(default_config(icp_candidates=mode, **CFG),
                                 device="cpu")
    assert (dgr.use_cand_for(16384), dgr.use_cand_for(32768)) == want


def test_bad_icp_candidates_raises_in_both_packages():
    with pytest.raises(ValueError, match="icp_candidates"):
        DeepGlobalRegistration(default_config(icp_candidates="always", **CFG),
                               device="cpu")
    with pytest.raises(ValueError, match="icp_candidates"):
        JaxDGR(jax_config(icp_candidates="always", **CFG))


def test_register_with_candidates_on():
    """register() with icp_candidates='on' on a small pair: candidate mode,
    and the same pose as the full-scan configuration."""
    rng = np.random.RandomState(5)
    xyz = (rng.rand(400, 3) * 1.2).astype(np.float32)
    xyz1 = xyz + np.array([8, -8, 16], np.float32) * 0.05
    Ts = {}
    for mode in ("on", "off"):
        dgr = DeepGlobalRegistration(default_config(icp_candidates=mode, **CFG),
                                     device="cpu")
        Ts[mode] = dgr.register(xyz, xyz1)
        assert dgr.last_iterations["icp_mode"] == (
            "candidates" if mode == "on" else "full")
        assert dgr.cand_fallbacks == 0 or mode == "on"
    np.testing.assert_allclose(Ts["on"], Ts["off"], atol=1e-4)


def test_lidar_range_candidates_match_jax_and_the_scans():
    """A LiDAR-like pair (ranges to 45 m, ~10k voxels a cloud) from the
    near-converged init of the chip check: both packages' candidate ICP run
    the same iterations to poses within 1e-5, and each package's full scan
    lands within 1e-4 of its candidate pose. The scans' iteration counts are
    not compared: their f32 |a|^2 - 2a.b + |b|^2 rounds there by more than
    the 1e-6 rmse stop rule, so where each stops depends on the order of its
    sums (``tests/torch_port_icp_gap.py`` prints them)."""
    from torch_port_icp_gap import icp_gap

    r = icp_gap(n=12000, seed=0)
    assert r["rows"][0] > 5000 and r["rows"][1] > 5000
    assert r["jax_cand"]["cand_ok"] and r["port_cand"]["cand_ok"]
    assert r["port_cand"]["iterations"] == r["jax_cand"]["iterations"]
    np.testing.assert_allclose(r["port_cand"]["rmse"], r["jax_cand"]["rmse"], rtol=1e-5)
    assert r["jax_cand_vs_full_max_abs_dT"] <= 1e-4
    assert r["port_cand_vs_full_max_abs_dT"] <= 1e-4
    assert r["port_vs_jax_full_max_abs_dT"] <= 1e-4
