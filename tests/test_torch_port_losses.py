"""Port vs JAX package: the training slice's small pieces.

The inlier BCE losses (``ops/losses.py``), train-mode BatchNorm with its
gradient (``ops/sparse_conv.batch_norm_train``), the sparse conv's written
backward (``gradcheck`` in f64), the correspondence labels
(``core/correspondence.py``) and the optimizers (``core/train_step.
make_optimizer`` against ``torch_sgd`` / ``make_optimizer`` of the JAX
package), on inputs from a seeded numpy RNG.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepglobalregistration_tpu.config import default_config as jax_config
from deepglobalregistration_tpu.core import correspondence as jcorr
from deepglobalregistration_tpu.core import train_step as jts
from deepglobalregistration_tpu.ops import losses as jlosses
from deepglobalregistration_tpu.ops import sparse_conv as jsc
from deepglobalregistration_tpu_torch.config import default_config
from deepglobalregistration_tpu_torch.core import correspondence, train_step as ts
from deepglobalregistration_tpu_torch.ops import edge_conv, kernel_map, losses, sparse_grid
from deepglobalregistration_tpu_torch.ops import sparse_conv as sc
from torch_port_trees import torch_threads


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


@pytest.mark.parametrize("case", ["mixed", "no_positive", "no_mask"])
def test_bce_losses_match_jax(case):
    rng = np.random.RandomState(0)
    logits = (rng.randn(3, 50) * 4).astype(np.float32)
    labels = (rng.rand(3, 50) < 0.3).astype(np.float32)
    mask = rng.rand(3, 50) < 0.8
    if case == "no_positive":  # an absent class contributes 0 to the balanced loss
        labels[:] = 0.0
    if case == "no_mask":
        mask = None
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    want = jax.jit(lambda x, y, m: (jlosses.bce_with_logits(x, y),
                                    jlosses.unbalanced_loss(x, y, m),
                                    jlosses.balanced_loss(x, y, m)))(
        jnp.asarray(logits), jnp.asarray(labels), jm)
    x, y = torch.from_numpy(logits), torch.from_numpy(labels)
    got = (losses.bce_with_logits(x, y), losses.unbalanced_loss(x, y, tm),
           losses.balanced_loss(x, y, tm))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


def test_batch_norm_train_matches_jax():
    """Outputs, running statistics and the gradient of a weighted sum of the
    outputs (w.r.t. features, scale and bias), over [B, N, C] with a mask."""
    rng = np.random.RandomState(1)
    x = (rng.randn(2, 40, 5) * 3 + 1).astype(np.float32)
    mask = np.arange(40)[None] < np.array([[33], [21]])
    scale, bias = (1 + 0.2 * rng.randn(2, 5)).astype(np.float32)
    rm, rv = rng.rand(5).astype(np.float32), (1 + rng.rand(5)).astype(np.float32)
    w = rng.randn(2, 40, 5).astype(np.float32)

    def jloss(x, s, b):
        out, nm, nv = jsc.batch_norm_train(x, jnp.asarray(mask), s, b, rm, rv, 0.05)
        return jnp.sum(out * w * mask[..., None]), (out, nm, nv)

    (_, (jout, jnm, jnv)), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True))(x, scale, bias)
    tx, ts_, tb = (torch.from_numpy(a.copy()).requires_grad_() for a in (x, scale, bias))
    out, nm, nv = sc.batch_norm_train(tx, ts_, tb, torch.from_numpy(rm),
                                      torch.from_numpy(rv), 0.05,
                                      mask=torch.from_numpy(mask))
    (out * torch.from_numpy(w) * torch.from_numpy(mask)[..., None]).sum().backward()
    m = mask[..., None]
    np.testing.assert_allclose(out.detach().numpy() * m, np.asarray(jout) * m,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(nm.numpy(), np.asarray(jnm), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(nv.numpy(), np.asarray(jnv), rtol=1e-5, atol=1e-5)
    for t, g in zip((tx, ts_, tb), jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-5, atol=1e-5)
    # The port's flat rows (no mask) equal the masked rows' statistics.
    flat = torch.from_numpy(x[mask])
    out2, nm2, nv2 = sc.batch_norm_train(flat, ts_.detach(), tb.detach(),
                                         torch.from_numpy(rm), torch.from_numpy(rv), 0.05)
    np.testing.assert_allclose(out2.numpy(), out.detach().numpy()[mask], atol=1e-5)
    assert torch.allclose(nm2, nm, atol=1e-6) and torch.allclose(nv2, nv, atol=1e-6)


def test_correct_correspondence_bit_for_bit():
    """Indices past the JAX package's 16-bit hash field (32767 and up),
    padding rows on both sides; the reference's host oracle agrees."""
    rng = np.random.RandomState(2)
    b, p, q = 3, 300, 400
    pos = rng.randint(0, 70000, (b, p, 2)).astype(np.int32)
    pred = rng.randint(0, 70000, (b, q, 2)).astype(np.int32)
    pred[:, ::3] = pos[:, :134]  # a third of the queries are positives
    pred[0, 5] = [32767, 32767]
    pos[0, 7] = [32767, 32767]
    pred[1, 9] = pos[1, 299]  # a positive in the padding: not a match
    pos_num, pred_num = np.array([300, 250, 0]), np.array([400, 399, 200])
    want = np.asarray(jax.jit(jax.vmap(jcorr.find_correct_correspondence))(
        pos, jnp.asarray(pos_num), pred, jnp.asarray(pred_num)))
    got = correspondence.find_correct_correspondence(
        torch.from_numpy(pos), torch.from_numpy(pos_num), torch.from_numpy(pred),
        torch.from_numpy(pred_num)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0, 5] and not got[1, 9] and not got[2].any() and not got[1, 399]
    for i in range(b):
        oracle = correspondence.find_correct_correspondence_np(
            pos[i, :pos_num[i]], pred[i, :pred_num[i]])
        np.testing.assert_array_equal(got[i, :pred_num[i]], oracle)


@pytest.mark.parametrize("name", ["SGD", "Adam"])
def test_optimizer_matches_jax_over_5_steps(name):
    """The port's torch.optim at the config's settings against the JAX
    package's optax transform (unit LR, scaled by the epoch LR as its
    trainer does) over 5 steps, then a skipped step on a NaN gradient.
    SGD agrees to 1e-6; Adam to 5e-6 (measured 2.0e-6): optax forms the bias
    correction 1 - b2^t in f32, where 0.999 itself rounds by 1.3e-5 of
    1 - 0.999, and torch forms it in f64."""
    rng = np.random.RandomState(3)
    p0 = {"a": rng.randn(4, 3).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
    cfg = dict(lr=0.07, weight_decay=1e-3)
    jopt = jts.make_optimizer(name, 1.0, jax_config(**cfg))
    jp = jax.tree.map(jnp.asarray, p0)
    jstate = jopt.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    topt = ts.make_optimizer(name, list(tp.values()), default_config(**cfg))
    for _ in range(5):
        g = {k: rng.randn(*v.shape).astype(np.float32) for k, v in p0.items()}
        upd, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, jax.tree.map(lambda u: 0.07 * u, upd))
        for k, v in tp.items():
            v.grad = torch.from_numpy(g[k])
        assert ts.grads_finite(tp.values())
        topt.step()
        for k in p0:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-6 if name == "SGD" else 5e-6)
    before = {k: v.detach().clone() for k, v in tp.items()}
    state = {k: {s: t.clone() for s, t in topt.state[v].items()} for k, v in tp.items()}
    tp["b"].grad = torch.full_like(tp["b"], float("nan"))
    assert not ts.grads_finite(tp.values())
    for k, v in tp.items():
        assert torch.equal(before[k], v.detach())
        for s, t in topt.state[v].items():
            assert torch.equal(state[k][s], t)


@pytest.mark.parametrize("case", ["3d_self", "3d_down", "6d_cross_up"])
def test_sparse_conv_backward_gradcheck(case):
    """The conv's backward (recomputed gathers, swapped edge lists with
    W^T, per-tile g^T dy) against finite differences in f64, on a self map,
    a stride-2 down map and the transposed (up) map of a 6D cross region,
    with ragged tiles of 4 edges; bias and input included."""
    rng = np.random.RandomState(4)
    D = 6 if case.startswith("6d") else 3
    c = np.unique(rng.randint(0, 5, (80, D)), axis=0)[:50]
    grid = torch.cat([torch.zeros((len(c), 1), dtype=torch.int64),
                      torch.from_numpy(c).long()], 1)
    region = kernel_map.HYPER_CROSS if D == 6 else kernel_map.HYPER_CUBE
    offs = kernel_map.kernel_offsets(3, D, region)
    if case == "3d_self":
        em = edge_conv.build_edge_map(kernel_map.build_kernel_map(grid, grid, offs, 1),
                                      tile=4)
    else:
        coarse = sparse_grid.stride_down(grid, 2)
        dn, up = edge_conv.build_edge_maps(
            kernel_map.build_kernel_map(grid, coarse, offs, 1), tile=4)
        em = dn if case == "3d_down" else up
    x = torch.from_numpy(rng.randn(em.n_in, 3)).requires_grad_()
    w = torch.from_numpy(rng.randn(len(offs), 3, 2)).requires_grad_()
    b = torch.from_numpy(rng.randn(2)).requires_grad_()
    assert em.n_edges > 0 and x.dtype == torch.float64
    assert torch.autograd.gradcheck(lambda x, w, b: sc.sparse_conv(x, w, em, b),
                                    (x, w, b))
