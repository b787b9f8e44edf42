"""Port vs JAX package: the ``ops/`` helpers no pipeline path calls.

``se3.matrix_inverse_se3``, ``procrustes.procrustes`` (with and without a
mask), ``knn.find_knn`` (one pair), ``knn.find_nn_xyz``,
``sparse_conv.sparse_avg_pool`` (f32 and bf16) and
``sparse_conv.cat_features``, each on the same numpy inputs in both
packages. Float results agree to 1e-5 (f32 sums in another order; a bf16
result to its last bit's rounding), indices exactly. ``se3.random_rotation``
draws from a ``torch.Generator`` where the JAX function draws from a key,
so it is held by its properties: orthonormal, det 1, the angle within half
the range, the same rotation from the same seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from deepglobalregistration_tpu.ops import knn as jknn
from deepglobalregistration_tpu.ops import procrustes as jproc
from deepglobalregistration_tpu.ops import se3 as jse3
from deepglobalregistration_tpu.ops import sparse_conv as jsc
from deepglobalregistration_tpu_torch.ops import edge_conv, knn, procrustes, se3
from deepglobalregistration_tpu_torch.ops import sparse_conv as sc
from deepglobalregistration_tpu_torch.ops.kernel_map import Edges
from deepglobalregistration_tpu_torch.utils import device as device_utils

T_ = torch.from_numpy


def _transforms(rng, b=3):
    T = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    T[:, :3, :3] = Rotation.from_rotvec(rng.randn(b, 3)).as_matrix()
    T[:, :3, 3] = rng.randn(b, 3)
    return T


def _edge_map(kmap: np.ndarray, n_in: int) -> edge_conv.EdgeMap:
    """The port's tiled edge map of a JAX kernel map [K, M] (-1 = empty)."""
    k, out = np.nonzero(kmap >= 0)
    return edge_conv.build_edge_map(Edges(
        T_(k.astype(np.int64)), T_(kmap[k, out].astype(np.int64)),
        T_(out.astype(np.int64)), n_in, kmap.shape[1], kmap.shape[0]))


def _case(name, rng):
    """(port result, JAX result, tolerance) of one helper on seeded inputs."""
    if name == "matrix_inverse_se3":
        T = _transforms(rng)
        return se3.matrix_inverse_se3(T_(T)), jse3.matrix_inverse_se3(T), 1e-5
    if name in ("procrustes", "procrustes_mask"):
        X = rng.rand(200, 3).astype(np.float32)
        Y = X @ _transforms(rng, 1)[0, :3, :3].T + 0.1
        Y[:40] = rng.rand(40, 3)  # outliers, masked out below
        mask = (np.arange(200) >= 40) if name == "procrustes_mask" else None
        R, t = procrustes.procrustes(T_(X), T_(Y), None if mask is None else T_(mask))
        jR, jt = jproc.procrustes(X, Y, mask)
        return torch.cat([R, t[:, None]], 1), np.concatenate([jR, jt[:, None]], 1), 1e-5
    if name in ("find_knn", "find_nn_xyz"):
        c = 16 if name == "find_knn" else 3
        F0 = rng.randn(200, c).astype(np.float32)
        F1 = rng.randn(300, c).astype(np.float32)
        if name == "find_knn":
            idx, d2 = knn.find_knn(T_(F0), T_(F1), 150, 250, k=4)
            jidx, jd2 = jknn.find_knn(F0, F1, jnp.int32(150), jnp.int32(250), k=4)
        else:
            idx, d2 = knn.find_nn_xyz(T_(F0), T_(F1), 150, 250)
            jidx, jd2 = jknn.find_nn_xyz(F0, F1, jnp.int32(150), jnp.int32(250))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        return d2, jd2, 1e-5
    if name.startswith("sparse_avg_pool"):
        kmap = np.where(rng.rand(27, 50) < 0.4, rng.randint(0, 60, (27, 50)), -1)
        kmap[:, 7] = -1  # an output row without an edge
        feats = rng.randn(60, 8).astype(np.float32)
        if name.endswith("bf16"):
            got = sc.sparse_avg_pool(T_(feats).bfloat16(), _edge_map(kmap, 60))
            want = jsc.sparse_avg_pool(jnp.asarray(feats, jnp.bfloat16), kmap)
            return got.float(), np.asarray(want, np.float32), 2.0 ** -7
        return (sc.sparse_avg_pool(T_(feats), _edge_map(kmap, 60)),
                jsc.sparse_avg_pool(feats, kmap), 1e-5)
    a, b = rng.randn(30, 4).astype(np.float32), rng.randn(30, 6).astype(np.float32)
    return sc.cat_features(T_(a), T_(b)), jsc.cat_features(a, b), 0.0


@pytest.mark.parametrize("name", ["matrix_inverse_se3", "procrustes", "procrustes_mask",
                                  "find_knn", "find_nn_xyz", "sparse_avg_pool",
                                  "sparse_avg_pool_bf16", "cat_features"])
def test_helper_matches_jax(name):
    got, want, tol = _case(name, np.random.RandomState(0))
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("range_deg", [360.0, 20.0])
def test_random_rotation_properties(range_deg):
    for seed in range(8):
        R = se3.random_rotation(device_utils.generator(seed), range_deg).double()
        np.testing.assert_allclose((R @ R.T).numpy(), np.eye(3), atol=1e-5)
        assert abs(float(torch.linalg.det(R)) - 1.0) < 1e-5
        angle = np.degrees(np.arccos(np.clip((float(torch.trace(R)) - 1) / 2, -1, 1)))
        assert angle <= range_deg / 2 + 1e-3
        again = se3.random_rotation(device_utils.generator(seed), range_deg).double()
        assert torch.equal(R, again)
    # The JAX function's rotations have the same properties.
    jR = np.asarray(jse3.random_rotation(jax.random.PRNGKey(0), range_deg), np.float64)
    np.testing.assert_allclose(jR @ jR.T, np.eye(3), atol=1e-5)
