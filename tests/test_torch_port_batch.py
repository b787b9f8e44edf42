"""Port vs JAX package: ``register_batch`` and its batched pieces.

The same numpy inputs (seeded) go to both packages; each case names its
tolerance:

- batched 1-NN: ``find_nn_batched`` (the plain version on the CPU) equals
  ``find_nn_plain`` pair by pair exactly, and the JAX package's ``find_nn``
  under ``vmap`` with per-pair counts in indices (near-ties aside) and d2 to
  ``tests/test_torch_port_knn.py``'s rtol 1e-6, on ragged counts with
  ``num1 = 0`` and ``num0 = 0`` pairs; the batched CUDA wrappers raise on
  CPU tensors and otherwise launch once for the batch and count it;
- batched refinement: per pair the unbatched port call's iterations and R/t
  to 1e-5 (sums over padded rows round differently), and the JAX function
  under ``vmap`` on the same padded inputs to 1e-4 (``test_torch_port_
  geometry.py``'s tolerance); a batch of one equals the unbatched call;
- batched ICP (full scan and candidate lists): per pair the unbatched port
  call to 1e-5 and the JAX function under ``vmap`` to 1e-4, equal
  ``cand_ok`` and iteration counts (small coordinates keep the scan's d2
  rounding below the 1e-6 stop rule), one pair stale while others converge;
- the whole batch: ``register_batch(force_vmapped=True)`` against the JAX
  package's at atol 1e-3 (``test_torch_port_pipeline.py``'s whole-slice
  tolerance) and against the port's own ``register()`` at 1e-3;
- the two-pass rerun: every pair failing the gate gives, bit for bit, a
  fresh instance's ``register()`` calls in pair order (seeded RANSAC);
- routing: sub-batches of 4, ``force_vmapped=False`` is ``register_many``,
  a ``mesh=`` rank on another device than the instance's raises (the
  fan-out itself: ``tests/test_torch_port_parallel_fanout.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from deepglobalregistration_tpu.config import default_config as jax_config
from deepglobalregistration_tpu.core import registration as jreg
from deepglobalregistration_tpu.core.pipeline import DeepGlobalRegistration as JaxDGR
from deepglobalregistration_tpu.ops import icp as jicp
from deepglobalregistration_tpu.ops import knn as jknn
from deepglobalregistration_tpu_torch.config import default_config
from deepglobalregistration_tpu_torch.core import registration
from deepglobalregistration_tpu_torch.core.pipeline import DeepGlobalRegistration
from deepglobalregistration_tpu_torch.ops import icp, knn
from deepglobalregistration_tpu_torch.parallel import data_parallel as dp
from deepglobalregistration_tpu_torch.utils.convert import from_jax_params

T_ = torch.from_numpy
CFG = dict(feat_model="ResUNetBN2F", feat_model_n_out=8, feat_conv1_kernel_size=3,
           inlier_model="ResUNetBN2FX", inlier_conv1_kernel_size=3,
           voxel_size=0.05, inlier_feature_type="ones",
           point_buckets="512,1024", ransac_hypotheses=512, level_shrink=1)


def _pad(arrays):
    """Stack [n_i, ...] arrays into [B, max n_i, ...], zero-padded."""
    n = max(len(a) for a in arrays)
    out = np.zeros((len(arrays), n) + arrays[0].shape[1:], arrays[0].dtype)
    for k, a in enumerate(arrays):
        out[k, :len(a)] = a
    return out


@pytest.mark.parametrize("c", [3, 32])
def test_find_nn_batched_matches_per_pair_and_jax_vmap(c):
    rng = np.random.RandomState(c)
    F0 = rng.randn(4, 200, c).astype(np.float32)
    F1 = rng.randn(4, 240, c).astype(np.float32)
    num0, num1 = [200, 150, 0, 120], [240, 0, 100, 180]
    idx, d = knn.find_nn_batched(T_(F0), T_(F1), num0, num1)
    assert idx.shape == d.shape == (4, 200) and idx.dtype == torch.int32
    j_idx, j_d = jax.vmap(jknn.find_nn)(jnp.asarray(F0), jnp.asarray(F1),
                                        jnp.asarray(num0, jnp.int32),
                                        jnp.asarray(num1, jnp.int32))
    j_idx, j_d = np.asarray(j_idx), np.asarray(j_d)
    for p in range(4):
        i_p, d_p = knn.find_nn_plain(T_(F0[p]), T_(F1[p]), num0[p], num1[p])
        assert torch.equal(idx[p], i_p) and torch.equal(d[p], d_p)
        a, b = idx[p].numpy(), d[p].numpy()
        assert np.all(a[num0[p]:] == 0) and np.all(np.isinf(b[num0[p]:]))
        fin = np.isfinite(j_d[p])
        np.testing.assert_array_equal(np.isfinite(b), fin)
        f0, f1 = F0[p].astype(np.float64), F1[p].astype(np.float64)
        scale = (f0 ** 2).sum(1) + (f1[j_idx[p]] ** 2).sum(1)
        np.testing.assert_allclose(b[fin], j_d[p][fin], rtol=1e-6,
                                   atol=1e-6 * scale[fin].max(initial=1.0))
        diff = np.nonzero(a != j_idx[p])[0]  # near-ties only, as in the knn test
        da = ((f0[diff] - f1[a[diff]]) ** 2).sum(1)
        db = ((f0[diff] - f1[j_idx[p][diff]]) ** 2).sum(1)
        assert np.all(np.abs(da - db) <= 1e-5 * scale[diff])
        assert diff.size <= 1
    assert not np.isfinite(j_d[1]).any() and not np.isfinite(j_d[2]).any()


@pytest.mark.parametrize("kernel", ["nn1_scan", "nn1_mma"])
def test_batched_wrappers_launch_their_kernel_or_raise(monkeypatch, kernel):
    """A batched wrapper never runs the plain version: CPU tensors raise; with
    the launch step replaced by a recorder it launches once for the batch,
    counts it, takes only its own widths and [B, 2] int32 counts."""
    c = 3 if kernel == "nn1_scan" else 32
    F0, F1 = torch.zeros(2, 6, c), torch.zeros(2, 5, c)
    nums = knn.pair_counts([6, 3], [5, 0], "cpu")
    wrapper = getattr(knn, f"{kernel}_batched")
    with pytest.raises(ValueError, match="CUDA"):
        wrapper(F0, F1, nums)
    calls = []
    monkeypatch.setattr(knn, "_call", lambda name, *args: calls.append((name, args[4])))
    monkeypatch.setattr(wrapper, "launches", 0)
    idx, d = wrapper(F0, F1, nums)
    assert len(calls) == 1 and calls[0][0] == kernel and calls[0][1] is nums
    assert idx.shape == d.shape == (2, 6) and wrapper.launches == 1
    other = knn.nn1_mma_batched if kernel == "nn1_scan" else knn.nn1_scan_batched
    with pytest.raises(ValueError, match="C <= "):
        other(F0, F1, nums)
    with pytest.raises(ValueError, match=r"\[B, 2\] int32"):
        wrapper(F0, F1, nums[:1])
    assert wrapper.launches == 1


def _corr(seed, n, noise):
    """Correspondences X -> Y = R X + t (+ noise, 30 % outliers), weights."""
    rng = np.random.RandomState(seed)
    R = Rotation.from_rotvec(rng.randn(3) * 0.3).as_matrix().astype(np.float32)
    t = (rng.randn(3) * 0.2).astype(np.float32)
    X = (rng.rand(n, 3) * 2).astype(np.float32)
    Y = X @ R.T + t + noise * rng.randn(n, 3).astype(np.float32)
    bad = rng.rand(n) < 0.3
    Y[bad] = (rng.rand(int(bad.sum()), 3) * 2).astype(np.float32)
    return X, Y.astype(np.float32), rng.rand(n).astype(np.float32)


def test_batched_refinement_freezes_each_pair():
    sets = [_corr(1, 600, 0.005), _corr(2, 450, 0.02), _corr(3, 520, 0.001)]
    X, Y, W = (_pad([s[k] for s in sets]) for k in range(3))
    kw = dict(break_threshold_ratio=1e-4, quantization_size=0.1)
    res = registration.global_registration(T_(X), T_(Y), T_(W), **kw)
    jres = jax.jit(jax.vmap(lambda a, b, c: jreg.global_registration(a, b, c, **kw)))(
        X, Y, W)
    assert len(set(res.iterations)) == 3  # pairs frozen while others run
    assert res.iterations == np.asarray(jres.iterations).tolist()
    np.testing.assert_allclose(res.R.numpy(), np.asarray(jres.R), atol=1e-4)
    np.testing.assert_allclose(res.t.numpy(), np.asarray(jres.t), atol=1e-4)
    for p, (x, y, w) in enumerate(sets):
        one = registration.global_registration(T_(x), T_(y), T_(w), **kw)
        assert one.iterations == res.iterations[p]
        np.testing.assert_allclose(res.R[p].numpy(), one.R.numpy(), atol=1e-5)
        np.testing.assert_allclose(res.t[p].numpy(), one.t.numpy(), atol=1e-5)
    b1 = registration.global_registration(T_(X[:1]), T_(Y[:1]), T_(W[:1]), **kw)
    one = registration.global_registration(T_(sets[0][0]), T_(sets[0][1]),
                                           T_(sets[0][2]), **kw)
    assert torch.equal(b1.R[0], one.R) and torch.equal(b1.t[0], one.t)
    assert b1.iterations == [one.iterations]


def _icp_pairs():
    """Three pairs at decimetre scale: two converge from small offsets, the
    third starts 6 degrees off (its candidate lists go stale)."""
    rng = np.random.RandomState(4)
    pairs = []
    for k, (n0, n1) in enumerate(((500, 470), (420, 400), (460, 450))):
        src = (rng.rand(n0, 3) * 0.6 - 0.3).astype(np.float32)
        tgt = (src + rng.randn(n0, 3).astype(np.float32) * 0.002 + 0.01)
        tgt = tgt[rng.permutation(n0)][:n1].astype(np.float32)
        init = np.eye(4, dtype=np.float32)
        init[:3, 3] = 0.004 * (k + 1)
        if k == 2:
            init[:3, :3] = Rotation.from_euler("z", 6, degrees=True).as_matrix()
        pairs.append((src, tgt, init))
    return pairs


@pytest.mark.parametrize("cand", [False, True], ids=["full_scan", "candidates"])
def test_batched_icp_matches_per_pair_and_jax_vmap(cand):
    pairs = _icp_pairs()
    S, G = _pad([p[0] for p in pairs]), _pad([p[1] for p in pairs])
    I = np.stack([p[2] for p in pairs])
    n0, n1 = [len(p[0]) for p in pairs], [len(p[1]) for p in pairs]
    mcd = 0.06
    res = icp.registration_icp(T_(S), T_(G), mcd, init=T_(I), use_candidates=cand,
                               num0=n0, num1=n1)
    jres = jax.jit(jax.vmap(lambda s, g, a, b, T: jicp.registration_icp(
        s, g, a, b, mcd, init=T, use_candidates=cand)))(
        S, G, jnp.asarray(n0, jnp.int32), jnp.asarray(n1, jnp.int32), I)
    assert res.cand_ok == np.asarray(jres.cand_ok).tolist()
    assert res.cand_ok == ([True, True, False] if cand else [True] * 3)
    assert res.iterations == np.asarray(jres.iterations).tolist()
    np.testing.assert_allclose(res.T.numpy(), np.asarray(jres.T), atol=1e-4)
    for p, (s, g, init) in enumerate(pairs):
        one = icp.registration_icp(T_(s), T_(g), mcd, init=T_(init),
                                   use_candidates=cand)
        assert (one.iterations, one.cand_ok) == (res.iterations[p], res.cand_ok[p])
        np.testing.assert_allclose(res.T[p].numpy(), one.T.numpy(), atol=1e-5)
    if cand:  # the stale pair stopped at once while the others went on
        assert res.iterations[2] < max(res.iterations[:2])


def _batch_pairs():
    """Three pairs of different sizes, each a grid-aligned translation (the
    FCGF features are equivariant to it, so both packages are well
    conditioned; every pair passes the gate)."""
    rng = np.random.RandomState(5)
    xs, ys = [], []
    for n, shift in ((700, (8, -8, 16)), (640, (-8, 16, 8)), (780, (16, 8, -8))):
        x = (rng.rand(n, 3) * 1.2).astype(np.float32)
        y = (x + np.array(shift, np.float32) * 0.05)[rng.permutation(n)][:n - 20]
        xs.append(x)
        ys.append(np.ascontiguousarray(y, np.float32))
    return xs, ys


@pytest.fixture(scope="module")
def batch_of_both():
    """The JAX package's register_batch(force_vmapped=True) on the three
    pairs, and a port instance carrying the same nets."""
    jdgr = JaxDGR(jax_config(**CFG))
    dgr = DeepGlobalRegistration(default_config(**CFG), device="cpu")
    dgr.fcgf.load_state_dict(from_jax_params(jdgr.fcgf_params, jdgr.fcgf_state,
                                             jdgr.fcgf_cfg))
    dgr.inlier.load_state_dict(from_jax_params(jdgr.inlier_params,
                                               jdgr.inlier_state, jdgr.inlier_cfg))
    xs, ys = _batch_pairs()
    return dgr, xs, ys, jdgr.register_batch(xs, ys, force_vmapped=True)


def test_register_batch_matches_jax_and_register(batch_of_both):
    dgr, xs, ys, T_jax = batch_of_both
    T = dgr.register_batch(xs, ys, force_vmapped=True)
    assert T.dtype == np.float64 and T.shape == (3, 4, 4)
    assert dgr.last_batch["gate"] == [True] * 3
    assert dgr.last_batch["rerun"] == [False] * 3
    assert dgr.last_batch["icp_mode"] == ["full"] and dgr.last_batch["cap"] == [1024]
    np.testing.assert_allclose(T, T_jax, atol=1e-3)
    for p in range(3):
        np.testing.assert_allclose(T[p], dgr.register(xs[p], ys[p]), atol=1e-3)
    assert dgr.overflow_count == 0


def test_gate_failures_rerun_through_register_in_order():
    """clip_weight_thresh = 1 zeroes every weight: every pair fails the gate
    and reruns through register() (RANSAC from the instance's seeded
    generator), in pair order, so a fresh instance's register() calls in the
    same order give the same transforms bit for bit."""
    cfg = default_config(**dict(CFG, clip_weight_thresh=1.0))
    xs, ys = _batch_pairs()
    dgr = DeepGlobalRegistration(cfg, device="cpu")
    T = dgr.register_batch(xs, ys, force_vmapped=True)
    assert dgr.last_batch["gate"] == [False] * 3
    assert dgr.last_batch["rerun"] == [True] * 3
    fresh = DeepGlobalRegistration(cfg, device="cpu")
    want = np.stack([fresh.register(x, y) for x, y in zip(xs, ys)])
    assert fresh.last_branch == "ransac"
    np.testing.assert_array_equal(T, want)


def test_register_batch_routing(batch_of_both, monkeypatch):
    dgr, xs, ys, _ = batch_of_both
    xs5, ys5 = (xs + xs[:2])[:5], (ys + ys[:2])[:5]
    sizes = []
    sub = dgr._register_sub_batch
    monkeypatch.setattr(dgr, "_register_sub_batch",
                        lambda a, b: sizes.append(len(a)) or sub(a, b))
    T5 = dgr.register_batch(xs5, ys5, force_vmapped=True)
    assert sizes == [4, 1] and T5.shape == (5, 4, 4)
    assert len(dgr.last_batch["gate"]) == 5 and len(dgr.last_batch["cap"]) == 2
    np.testing.assert_allclose(T5[3:], T5[:2], atol=1e-3)  # the same pairs again
    np.testing.assert_array_equal(dgr.register_batch(xs[:2], ys[:2]),
                                  dgr.register_many(xs[:2], ys[:2]))
    with pytest.raises(ValueError, match="this instance on cpu"):
        dgr.register_batch(xs, ys, mesh=dp.Mesh(("cuda:0",), "nccl"))
