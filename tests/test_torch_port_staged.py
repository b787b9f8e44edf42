"""Port vs JAX package: the staged API, the safeguard's distance checker and
feature-matching RANSAC, and the host KD-tree matching route.

Small nets (ResUNetBN2F FCGF, ResUNetBN2FX inlier net) carry the JAX
instance's weights. Stage by stage on the same inputs: voxel rows and
coordinates equal exactly (first-occurrence choice, as in the JAX package);
FCGF features atol 1e-4 and inlier logits atol 1e-3 (f32 sums in another
order through four-level nets, as in the port's net tests); 1-NN indices
equal on the same features; RANSAC with shared hypothesis draws gives the
same pose to atol 1e-4. Draws from each package's own generator differ, so
the safeguard's pose is held to the ground truth instead (translation atol
2 cm, rotation atol 5e-3, as ``tests/test_pipeline.py`` does).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepglobalregistration_tpu.config import default_config as jax_config
from deepglobalregistration_tpu.core.pipeline import DeepGlobalRegistration as JaxDGR
from deepglobalregistration_tpu.ops import ransac as jransac
from deepglobalregistration_tpu_torch.config import default_config
from deepglobalregistration_tpu_torch.core.pipeline import DeepGlobalRegistration
from deepglobalregistration_tpu_torch.ops import knn, ransac
from deepglobalregistration_tpu_torch.utils.convert import from_jax_params

T_ = torch.from_numpy
CFG = dict(feat_model="ResUNetBN2F", feat_model_n_out=8, feat_conv1_kernel_size=3,
           inlier_model="ResUNetBN2FX", inlier_conv1_kernel_size=3,
           voxel_size=0.05, inlier_feature_type="ones",
           point_buckets="512,1024", ransac_hypotheses=512, level_shrink=1)
SHIFT = np.array([8, 8, 8], np.float32) * 0.05


def _port(jdgr, **kw):
    dgr = DeepGlobalRegistration(default_config(**dict(CFG, **kw)), device="cpu")
    dgr.fcgf.load_state_dict(from_jax_params(jdgr.fcgf_params, jdgr.fcgf_state,
                                             jdgr.fcgf_cfg))
    dgr.inlier.load_state_dict(from_jax_params(jdgr.inlier_params,
                                               jdgr.inlier_state, jdgr.inlier_cfg))
    return dgr


@pytest.fixture(scope="module")
def jdgr():
    return JaxDGR(jax_config(**CFG))


@pytest.fixture(scope="module")
def cloud():
    return (np.random.RandomState(0).rand(350, 3) * 1.2).astype(np.float32)


def test_staged_chain_matches_jax(jdgr, cloud):
    dgr = _port(jdgr)
    xyz0, xyz1 = cloud, cloud + SHIFT
    staged = {}
    for name, p in (("port", dgr), ("jax", jdgr)):
        x0, c0, f0 = p.preprocess(xyz0)
        x1, c1, f1 = p.preprocess(xyz1)
        staged[name] = (x0, c0, f0, x1, c1, f1,
                        p.fcgf_feature_extraction(f0, c0),
                        p.fcgf_feature_extraction(f1, c1))
    for a, b in zip(staged["port"][:6], staged["jax"][:6]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    x0, c0, f0, x1, c1, f1, feats0, feats1 = staged["port"]
    np.testing.assert_allclose(feats0, staged["jax"][6], atol=1e-4)
    np.testing.assert_allclose(feats1, staged["jax"][7], atol=1e-4)

    # Matching and what follows, on the same (JAX) features in both.
    jf0, jf1 = staged["jax"][6], staged["jax"][7]
    i0, i1 = dgr.fcgf_feature_matching(jf0, jf1)
    j0, j1 = jdgr.fcgf_feature_matching(jf0, jf1)
    np.testing.assert_array_equal(i0, j0)
    np.testing.assert_array_equal(i1, j1)
    assert i0.dtype == j0.dtype and i1.dtype == j1.dtype
    # translation-equivariant features recover the shifted voxels
    np.testing.assert_array_equal(c1[i1], c0 + np.array([8, 8, 8], np.int32))

    ifeat = dgr.inlier_feature_generation(x0, x1, c0, c1, jf0, jf1, i0, i1)
    np.testing.assert_array_equal(
        ifeat, jdgr.inlier_feature_generation(x0, x1, c0, c1, jf0, jf1, i0, i1))
    coords6 = np.concatenate([c0[i0], c1[i1]], axis=1)
    logits = dgr.inlier_prediction(ifeat, coords6)
    assert logits.shape == (len(i0), 1) and logits.dtype == np.float32
    np.testing.assert_allclose(logits, jdgr.inlier_prediction(ifeat, coords6),
                               atol=1e-3)

    for method in ("correspondence", "feature_matching"):
        dgr.safeguard_method = method
        T = dgr.safeguard_registration(x0, x1, i0, i1, jf0, jf1,
                                       distance_threshold=2 * dgr.voxel_size,
                                       num_iterations=2048)
        assert T.dtype == np.float64 and T.shape == (4, 4)
        np.testing.assert_allclose(T[:3, 3], SHIFT, atol=0.02)
        np.testing.assert_allclose(T[:3, :3], np.eye(3), atol=5e-3)


def test_safeguard_clamps_the_hypothesis_budget(jdgr, cloud, monkeypatch):
    dgr = _port(jdgr)
    seen = []

    def spy(*a, num_hypotheses, **k):
        seen.append(num_hypotheses)
        raise StopIteration

    monkeypatch.setattr(ransac, "ransac_correspondence", spy)
    for n in (10, 5000, 10 ** 6):
        with pytest.raises(StopIteration):
            dgr.safeguard_registration(cloud, cloud, np.arange(5), np.arange(5),
                                       None, None, 0.1, n)
    assert seen == [1024, 5000, 65536]


def _rigid(seed):
    from scipy.spatial.transform import Rotation

    rng = np.random.RandomState(seed)
    R = Rotation.from_rotvec(rng.randn(3) * 0.3).as_matrix().astype(np.float32)
    return R, (rng.randn(3) * 0.2).astype(np.float32)


def test_checker_matches_jax():
    rng = np.random.RandomState(1)
    R, t = _rigid(1)
    sx = rng.rand(6, 4, 3).astype(np.float32)
    sy = (sx @ R.T + t).astype(np.float32)
    sy[1, 2] += np.float32([0.5, 0.0, 0.0])   # far beyond the checker
    sy[3, 0] += np.float32([0.0, 0.03, 0.0])  # inside it
    Rs = np.stack([R] * 6).astype(np.float32)
    ts = np.stack([t] * 6).astype(np.float32)
    ok = ransac._checker_distance_ok(T_(Rs), T_(ts), T_(sx), T_(sy), 0.05)
    j_ok = jransac._checker_distance_ok(jnp.asarray(Rs), jnp.asarray(ts),
                                        jnp.asarray(sx), jnp.asarray(sy), 0.05)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(j_ok))
    assert ok.tolist() == [True, False, True, True, True, True]


def test_ransac_feature_matching_with_shared_samples():
    rng = np.random.RandomState(2)
    R, t = _rigid(2)
    n, h = 400, 256
    src = (rng.rand(n, 3) * 2).astype(np.float32)
    tgt = (src @ R.T + t).astype(np.float32)
    feats0 = rng.randn(n, 16).astype(np.float32)
    feats1 = feats0.copy()
    scramble = rng.rand(n) < 0.4  # 40 % of the matches are wrong
    feats1[scramble] = feats1[scramble][rng.permutation(int(scramble.sum()))]
    key = jax.random.PRNGKey(3)
    samples = np.array(jax.random.randint(key, (h, 4), 0, n))
    jres = jax.jit(lambda k, a, b, f0, f1: jransac.ransac_feature_matching(
        k, a, b, f0, f1, jnp.int32(n), jnp.int32(n), distance_threshold=0.05,
        num_hypotheses=h))(key, src, tgt, feats0, feats1)
    res = ransac.ransac_feature_matching(T_(src), T_(tgt), T_(feats0), T_(feats1),
                                         0.05, samples=T_(samples))
    np.testing.assert_allclose(res.R.numpy(), np.asarray(jres.R), atol=1e-4)
    np.testing.assert_allclose(res.t.numpy(), np.asarray(jres.t), atol=1e-4)
    np.testing.assert_allclose(float(res.fitness), float(jres.fitness), atol=1e-6)
    np.testing.assert_allclose(res.R.numpy(), R, atol=1e-3)


def test_find_knn_cpu_equals_the_scan():
    rng = np.random.RandomState(4)
    f0 = rng.randn(300, 8).astype(np.float32)
    f1 = rng.randn(280, 8).astype(np.float32)
    idx = knn.find_knn_cpu(f0, f1)
    assert idx.shape == (300,)
    np.testing.assert_array_equal(idx, knn.find_nn(T_(f0), T_(f1))[0].numpy())
    idx3, d3 = knn.find_knn_cpu(f0, f1, knn=3, return_distance=True)
    assert idx3.shape == d3.shape == (300, 3)
    np.testing.assert_array_equal(idx3[:, 0], idx)


def test_knn_search_method_cpu_matches_gpu(jdgr, cloud):
    """'cpu' (host KD-tree) and 'gpu' (the 1-NN kernel's route) register
    the same pair alike."""
    xyz1 = cloud + np.array([8, -8, 8], np.float32) * 0.05
    T_gpu = _port(jdgr, knn_search_method="gpu").register(cloud, xyz1)
    T_cpu = _port(jdgr, knn_search_method="cpu").register(cloud, xyz1)
    np.testing.assert_allclose(T_cpu, T_gpu, atol=1e-4)
    np.testing.assert_allclose(T_cpu[:3, 3], [0.4, -0.4, 0.4], atol=0.02)


def test_feature_matching_safeguard_in_register(jdgr, cloud):
    """Every weight clipped fails the gate; the feature-matching safeguard
    then registers the pair, and repeats exactly from the seeded generator."""
    Ts = []
    for _ in range(2):
        dgr = _port(jdgr, clip_weight_thresh=1.0)
        dgr.safeguard_method = "feature_matching"
        Ts.append(dgr.register(cloud, cloud + SHIFT))
        assert dgr.last_branch == "ransac"
    np.testing.assert_array_equal(Ts[0], Ts[1])
    np.testing.assert_allclose(Ts[0][:3, 3], SHIFT, atol=0.02)
    np.testing.assert_allclose(Ts[0][:3, :3], np.eye(3), atol=5e-3)


def test_jax_config_fields_construct_in_both(jdgr, cloud):
    """The fields added for the JAX configuration: same defaults, and
    split_register, accepted and dropped, leaves the port's one (eager)
    path as it is."""
    jc, pc = jax_config(), default_config()
    for key in ("icp_candidates", "knn_search_method"):
        assert getattr(pc, key) == getattr(jc, key)
    assert default_config(split_register=True) == pc
    xyz1 = cloud + SHIFT
    np.testing.assert_array_equal(
        _port(jdgr, split_register=True).register(cloud, xyz1, inlier_thr=0.0),
        _port(jdgr).register(cloud, xyz1))
