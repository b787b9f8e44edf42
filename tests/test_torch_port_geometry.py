"""Port vs JAX package: Procrustes, the Adam refinement loop, RANSAC and ICP.

The same numpy inputs go to both. Poses agree to atol 1e-4 (f32 geometry;
sums in another order), and the loops stop after the same number of
iterations. RANSAC gets the same hypothesis draws through ``samples``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from deepglobalregistration_tpu.core import registration as jreg
from deepglobalregistration_tpu.ops import icp as jicp
from deepglobalregistration_tpu.ops import procrustes as jproc
from deepglobalregistration_tpu.ops import ransac as jransac
from deepglobalregistration_tpu_torch.core import registration
from deepglobalregistration_tpu_torch.ops import icp, procrustes, ransac

T_ = torch.from_numpy


def _pose(seed):
    rng = np.random.RandomState(seed)
    R = Rotation.from_rotvec(rng.randn(3) * 0.3).as_matrix().astype(np.float32)
    return R, (rng.randn(3) * 0.2).astype(np.float32)


def _corr(seed, n=600, outliers=0.3, noise=0.005):
    rng = np.random.RandomState(seed)
    R, t = _pose(seed)
    X = (rng.rand(n, 3) * 2).astype(np.float32)
    Y = X @ R.T + t + noise * rng.randn(n, 3).astype(np.float32)
    bad = rng.rand(n) < outliers
    Y[bad] = (rng.rand(int(bad.sum()), 3) * 2).astype(np.float32)
    w = rng.rand(n).astype(np.float32)
    return X, Y.astype(np.float32), w


def test_weighted_procrustes_matches():
    X, Y, w = _corr(0, outliers=0.0)
    R, t = procrustes.weighted_procrustes(T_(X), T_(Y), T_(w))
    jR, jt = jax.jit(jproc.weighted_procrustes)(X, Y, w)
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), atol=1e-5)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=1e-5)
    Rb, tb = procrustes.procrustes_batch(T_(np.stack([X[:4], X[4:8]])),
                                         T_(np.stack([Y[:4], Y[4:8]])))
    jRb, _ = jax.jit(jproc.procrustes_batch)(np.stack([X[:4], X[4:8]]),
                                             np.stack([Y[:4], Y[4:8]]),
                                             np.ones((2, 4), bool))
    np.testing.assert_allclose(Rb.numpy(), np.asarray(jRb), atol=1e-4)


@pytest.mark.parametrize("seed", [1, 2])
def test_global_registration_matches(seed):
    X, Y, w = _corr(seed)
    res = registration.global_registration(T_(X), T_(Y), T_(w),
                                           break_threshold_ratio=1e-4,
                                           quantization_size=0.1)
    jres = jax.jit(lambda a, b, c: jreg.global_registration(
        a, b, c, break_threshold_ratio=1e-4, quantization_size=0.1))(X, Y, w)
    assert res.iterations == int(jres.iterations) > 8
    np.testing.assert_allclose(res.R.numpy(), np.asarray(jres.R), atol=1e-4)
    np.testing.assert_allclose(res.t.numpy(), np.asarray(jres.t), atol=1e-4)


def test_ransac_with_shared_samples_matches():
    X, Y, _ = _corr(3, n=500, outliers=0.6)
    key = jax.random.PRNGKey(5)
    samples = np.array(jax.random.randint(key, (256, 4), 0, 500))
    jres = jax.jit(lambda k, a, b: jransac.ransac_correspondence(
        k, a, b, jnp.int32(500), distance_threshold=0.02, num_hypotheses=256))(
        key, X, Y)
    res = ransac.ransac_correspondence(T_(X), T_(Y), 0.02, samples=T_(samples))
    np.testing.assert_allclose(res.R.numpy(), np.asarray(jres.R), atol=1e-4)
    np.testing.assert_allclose(res.t.numpy(), np.asarray(jres.t), atol=1e-4)
    np.testing.assert_allclose(float(res.fitness), float(jres.fitness), atol=1e-6)


def test_icp_full_scan_matches():
    rng = np.random.RandomState(4)
    src = (rng.rand(700, 3) * 1.5).astype(np.float32)
    tgt = (src + rng.randn(700, 3).astype(np.float32) * 0.003 + 0.02).astype(np.float32)
    tgt = tgt[rng.permutation(700)][:650]
    init = np.eye(4, dtype=np.float32)
    init[:3, 3] = 0.01
    res = icp.registration_icp(T_(src), T_(tgt), 0.1, init=T_(init))
    jres = jax.jit(lambda a, b, T: jicp.registration_icp(
        a, b, jnp.int32(700), jnp.int32(650), 0.1, init=T))(src, tgt, init)
    assert res.iterations == int(jres.iterations) > 1
    np.testing.assert_allclose(res.T.numpy(), np.asarray(jres.T), atol=1e-4)


@pytest.mark.parametrize("use_candidates,rot,shift", [(False, 0.05, 0.01),
                                                      (True, 0.01, 0.025)])
def test_icp_rmse_floor_matches(use_candidates, rot, shift):
    """``f32_rmse_floor=1e-3`` (the JAX package's legacy rule) stops the
    port's ICP at the JAX ICP's iteration, earlier than the default rule,
    at the same pose; the checked wrapper and a batch of two pass it on."""
    rng = np.random.RandomState(4)
    src = (rng.rand(700, 3) * 1.5).astype(np.float32)
    tgt = (src + rng.randn(700, 3).astype(np.float32) * 0.003 + 0.02).astype(np.float32)
    tgt = tgt[rng.permutation(700)][:650]
    init = np.eye(4, dtype=np.float32)
    init[:3, :3] = Rotation.from_rotvec([0, 0, rot]).as_matrix()
    init[:3, 3] = shift
    kw = dict(init=T_(init), use_candidates=use_candidates)
    res = icp.registration_icp(T_(src), T_(tgt), 0.1, f32_rmse_floor=1e-3, **kw)
    jres = jax.jit(lambda a, b, T: jicp.registration_icp(
        a, b, jnp.int32(700), jnp.int32(650), 0.1, init=T, f32_rmse_floor=1e-3,
        use_candidates=use_candidates))(src, tgt, init)
    assert res.cand_ok and bool(jres.cand_ok)
    assert res.iterations == int(jres.iterations)
    assert res.iterations < icp.registration_icp(T_(src), T_(tgt), 0.1, **kw).iterations
    np.testing.assert_allclose(res.T.numpy(), np.asarray(jres.T), atol=1e-4)
    if use_candidates:
        checked = icp.registration_icp_checked(T_(src), T_(tgt), 0.1, init=T_(init),
                                               f32_rmse_floor=1e-3)
        assert checked.iterations == res.iterations
        np.testing.assert_array_equal(checked.T.numpy(), res.T.numpy())
    src2 = T_(np.stack([src, src]))
    tgt2 = T_(np.stack([tgt, tgt]))
    batch = icp.registration_icp(src2, tgt2, 0.1, init=T_(np.stack([init, init])),
                                 use_candidates=use_candidates, num0=[700, 700],
                                 num1=[650, 650], f32_rmse_floor=1e-3)
    assert batch.iterations == [res.iterations] * 2
    np.testing.assert_allclose(batch.T.numpy(), np.stack([res.T.numpy()] * 2), atol=1e-4)
