"""Port's plain 1-NN scan vs the JAX package's scan and its Pallas kernel.

Inputs come from numpy with a seed. Indices must be equal on every row
except near-ties (two distinct candidates whose f64 squared distances agree
within 1e-5 of |a|^2 + |b|^2, which the cross term's summation order may
swap), and such rows may be at most 1e-4 of all rows (at least one); on
exactly duplicated candidates, where ties are exact, indices must be equal
with no exception. Squared distances agree to rtol 1e-6 (plus an absolute
1e-6 of the terms' magnitude for near-zero distances).

Kernel B's arithmetic (``csrc/nn1_mma.cu``, 3xTF32 on the tensor cores)
is emulated with torch bit rounding at C = 32 and held to its contract: d2
within ``knn.MMA_D2_RTOL`` (2^-20) of |a|^2 + |b|^2 against the f64 value,
the index equal to the JAX scan's except near-ties within that tolerance
(at most 1e-4 of the rows, at least one), and equal with no exception on
exact duplicates.

The device guard: a CUDA-only wrapper never runs the plain version on CPU
tensors, and the dispatcher takes the plain version only for CPU tensors.
``find_nn_cuda`` sends C <= 8 to kernel A (``nn1_scan``) and 8 < C <= 64 to
kernel B (``nn1_mma``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepglobalregistration_tpu.ops import knn as jknn
from deepglobalregistration_tpu.ops.pallas_knn import find_nn_pallas
from deepglobalregistration_tpu_torch.ops import knn

CASES = [  # (n0, n1, c, num0, num1)
    (300, 520, 3, 300, 520),
    (300, 520, 32, 300, 520),
    (300, 520, 32, 211, 377),
    (260, 300, 3, 190, 0),
]


def _inputs(n0, n1, c, seed, dup=False):
    rng = np.random.RandomState(seed)
    if dup:
        base = rng.randn(n1 // 4, c).astype(np.float32)
        F1 = np.tile(base, (4, 1))
        F0 = F1[rng.permutation(n1)][:n0]
        return F0, F1
    return rng.randn(n0, c).astype(np.float32), rng.randn(n1, c).astype(np.float32)


def _compare(F0, F1, num0, idx_a, d_a, idx_b, d_b, exact_ties=False):
    f0, f1 = F0.astype(np.float64), F1.astype(np.float64)
    scale = (f0 ** 2).sum(1) + (f1[idx_b] ** 2).sum(1)
    finite = np.isfinite(d_b)
    np.testing.assert_array_equal(np.isfinite(d_a), finite)
    np.testing.assert_allclose(d_a[finite], d_b[finite], rtol=1e-6,
                               atol=1e-6 * scale[finite].max(initial=1.0))
    diff = np.nonzero(idx_a != idx_b)[0]
    if exact_ties:
        assert diff.size == 0
    if diff.size:
        da = ((f0[diff] - f1[idx_a[diff]]) ** 2).sum(1)
        db = ((f0[diff] - f1[idx_b[diff]]) ** 2).sum(1)
        assert np.all(np.abs(da - db) <= 1e-5 * scale[diff])
        assert diff.size <= max(1, int(1e-4 * num0))


@pytest.mark.parametrize("n0,n1,c,num0,num1", CASES)
def test_plain_matches_jax_scan_and_pallas(n0, n1, c, num0, num1):
    F0, F1 = _inputs(n0, n1, c, seed=n0 + c + num1)
    idx, d = knn.find_nn(torch.from_numpy(F0), torch.from_numpy(F1), num0, num1)
    idx, d = idx.numpy(), d.numpy()
    assert idx.dtype == np.int32 and d.dtype == np.float32
    j_idx, j_d = jknn.find_nn(jnp.asarray(F0), jnp.asarray(F1), jnp.int32(num0),
                              jnp.int32(num1))
    _compare(F0, F1, num0, idx, d, np.asarray(j_idx), np.asarray(j_d))
    p_idx, p_d = find_nn_pallas(jnp.asarray(F0), jnp.asarray(F1), jnp.int32(num0),
                                jnp.int32(num1), interpret=True)
    _compare(F0, F1, num0, idx, d, np.asarray(p_idx), np.asarray(p_d))
    assert np.all(idx[num0:] == 0) and np.all(np.isinf(d[num0:]))


@pytest.mark.parametrize("c", [3, 32])
def test_duplicate_candidates_take_the_lowest_index(c):
    F0, F1 = _inputs(400, 400, c, seed=7, dup=True)
    idx, d = knn.find_nn_plain(torch.from_numpy(F0), torch.from_numpy(F1), 400, 400,
                               tile=128)  # ties span several candidate tiles
    j_idx, j_d = jknn.find_nn(jnp.asarray(F0), jnp.asarray(F1), jnp.int32(400),
                              jnp.int32(400), tile=128)
    _compare(F0, F1, 400, idx.numpy(), d.numpy(), np.asarray(j_idx),
             np.asarray(j_d), exact_ties=True)
    assert int(idx.max()) < 100  # every row's twin in the first copy wins


def test_cuda_wrapper_never_runs_the_plain_version_on_cpu(monkeypatch):
    def forbidden(*a, **k):
        raise AssertionError("plain version called from the CUDA wrapper")

    monkeypatch.setattr(knn, "find_nn_plain", forbidden)
    F = torch.zeros(8, 3)
    before = knn.find_nn_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        knn.find_nn_cuda(F, F, 8, 8)
    assert knn.find_nn_cuda.launches == before


@pytest.mark.parametrize("c", [0, 65])
def test_cuda_wrapper_rejects_unsupported_widths(c):
    F = torch.zeros(4, c)
    with pytest.raises(ValueError, match="C <= 64"):
        knn.find_nn_cuda(F, F, 4, 4)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (10 mantissa bits), to nearest with ties away from
    zero, as ``cvt.rna.tf32.f32`` rounds: add half of the dropped 13 bits to
    the magnitude's bit pattern, then clear them."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _mma_emulated(F0: torch.Tensor, F1: torch.Tensor):
    """Kernel B's arithmetic in plain torch: hi = tf32(x), lo = tf32(x - hi),
    cross = hi.hi + (lo.hi + hi.lo) (tf32 products are exact in f32), and
    d2 = |a|^2 - 2 cross + |b|^2 from the plain version's norms."""
    h0, h1 = _tf32(F0), _tf32(F1)
    l0, l1 = _tf32(F0 - h0), _tf32(F1 - h1)
    cross = h0 @ h1.T + (l0 @ h1.T + h0 @ l1.T)
    d = knn._sq_norms(F0)[:, None] - 2.0 * cross + knn._sq_norms(F1)[None, :]
    idx = torch.argmin(d, dim=1)  # first minimum: the lowest index
    return idx.numpy(), torch.gather(d, 1, idx[:, None])[:, 0].numpy()


@pytest.mark.parametrize("kind", ["randn", "unit", "duplicates"])
def test_mma_3xtf32_emulation_meets_the_contract(kind):
    one = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 2.0 ** -12])
    assert _tf32(one).tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1.0]
    n0, n1, c = 2000, 3000, 32
    if kind == "duplicates":
        F0, F1 = _inputs(n0, n1, c, seed=11, dup=True)
    else:
        F0, F1 = _inputs(n0, n1, c, seed=5)
        if kind == "unit":  # FCGF features are unit-norm
            F0 /= np.linalg.norm(F0, axis=1, keepdims=True)
            F1 /= np.linalg.norm(F1, axis=1, keepdims=True)
    idx, d = _mma_emulated(torch.from_numpy(F0), torch.from_numpy(F1))
    j_idx, _ = jknn.find_nn(jnp.asarray(F0), jnp.asarray(F1), jnp.int32(n0),
                            jnp.int32(n1))
    j_idx = np.asarray(j_idx)
    f0, f1 = F0.astype(np.float64), F1.astype(np.float64)
    tol = knn.MMA_D2_RTOL * ((f0 ** 2).sum(1) + (f1[idx] ** 2).sum(1))
    exact = ((f0 - f1[idx]) ** 2).sum(1)
    assert np.all(np.abs(d - exact) <= tol)
    diff = np.nonzero(idx != j_idx)[0]
    if kind == "duplicates":
        assert diff.size == 0
    dj = ((f0[diff] - f1[j_idx[diff]]) ** 2).sum(1)
    assert np.all(np.abs(exact[diff] - dj) <= tol[diff])
    assert diff.size <= max(1, int(1e-4 * n0))


@pytest.mark.parametrize("c,kernel", [(3, "nn1_scan"), (8, "nn1_scan"),
                                      (9, "nn1_mma"), (32, "nn1_mma"),
                                      (64, "nn1_mma"), (0, None), (65, None)])
def test_find_nn_cuda_dispatches_by_width(monkeypatch, c, kernel):
    """The launch step (``_call``, which loads the kernel's library) is
    replaced by a recorder, so CPU tensors reach the dispatch."""
    calls = []
    monkeypatch.setattr(knn, "_call", lambda name, *args: calls.append(name))
    for wrapper in (knn.find_nn_cuda, knn.nn1_scan, knn.nn1_mma):
        monkeypatch.setattr(wrapper, "launches", 0)
    F = torch.zeros(6, c)
    if kernel is None:
        with pytest.raises(ValueError, match="C <= 64"):
            knn.find_nn_cuda(F, F, 6, 6)
        assert calls == []
        return
    idx, d = knn.find_nn_cuda(F, F, 6, 6)
    assert calls == [kernel] and idx.shape == d.shape == (6,)
    assert knn.find_nn_cuda.launches == 1
    assert (knn.nn1_scan.launches, knn.nn1_mma.launches) == (
        (1, 0) if kernel == "nn1_scan" else (0, 1))
    other = knn.nn1_mma if kernel == "nn1_scan" else knn.nn1_scan
    with pytest.raises(ValueError, match="C <= "):
        other(F, F, 6, 6)  # each kernel takes only its own widths
