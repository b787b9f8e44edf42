"""Port vs JAX package: FCGF self-training (``core/fcgf_train.py``).

The hardest-contrastive loss of one pair on random features, and one
train-mode step of the FCGF net (ResUNetBN2F with 8 outputs, B = 2 pairs of
N = 192 padded rows, ``torch_port_trees.pair_batch`` in a 7-voxel box) with
its gradients and new BN statistics. The port's loss takes its random draws
as arguments: both tests feed it the draws the JAX step makes from its key.
The JAX step runs at ``level_shrink`` 1 (see test_torch_port_train_step.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepglobalregistration_tpu.config import default_config as jax_config
from deepglobalregistration_tpu.core import fcgf_train as jft
from deepglobalregistration_tpu.core import train_step as jts
from deepglobalregistration_tpu.models import load_model as jload
from deepglobalregistration_tpu_torch.config import default_config
from deepglobalregistration_tpu_torch.core import fcgf_train as ft
from deepglobalregistration_tpu_torch.core import train_step as ts
from deepglobalregistration_tpu_torch.data.collate import PairBatch
from deepglobalregistration_tpu_torch.models import load_model
from deepglobalregistration_tpu_torch.utils import convert
from torch_port_trees import numpy_tree, pair_batch, torch_threads

LOSS_CFG = ft.FCGFLossConfig(num_pos=256, num_neg=256)
# f32 both sides; measured gaps of the step: loss terms 1.0e-7 relative,
# gradients 8.4e-6 of a leaf's largest |entry|, running statistics 8.5e-8.
LOSS_RTOL, GRAD_RTOL, STATE_TOL = 1e-5, 5e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def jax_draws(key, pos_num, num0, num1, cfg):
    """The draws of the JAX step's ``hardest_contrastive_loss`` for each
    pair: its key split per pair, then into (positives, cloud-1 candidates,
    cloud-0 candidates), each ``randint(0, 2^30) % n``."""
    out = []
    for i, kk in enumerate(jax.random.split(key, len(pos_num))):
        k_pos, k_n0, k_n1 = jax.random.split(kk, 3)
        r = lambda k, n, size: torch.from_numpy(
            np.asarray(jax.random.randint(k, (size,), 0, 1 << 30)) % max(int(n), 1))
        out.append(ft.Draws(r(k_pos, pos_num[i], cfg.num_pos),
                            r(k_n0, num1[i], cfg.num_neg),
                            r(k_n1, num0[i], cfg.num_neg)))
    return out


def test_hardest_contrastive_loss_matches_jax():
    rng = np.random.RandomState(0)
    n0, n1, p = 150, 170, 120
    f0 = rng.randn(n0, 16).astype(np.float32) * 0.5
    f1 = rng.randn(n1, 16).astype(np.float32) * 0.5
    xyz0 = rng.rand(n0, 3).astype(np.float32)
    xyz1 = rng.rand(n1, 3).astype(np.float32)
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [0.05, -0.02, 0.01]
    pos = np.stack([rng.randint(0, 140, p), rng.randint(0, 160, p)], 1).astype(np.int32)
    key = jax.random.PRNGKey(3)
    jcfg = jft.FCGFLossConfig(*LOSS_CFG)

    def jloss(f0, f1):
        return jft.hardest_contrastive_loss(key, f0, f1, *map(jnp.asarray, (
            xyz0, xyz1, T, pos)), 100, n0, n1, jcfg)

    (want, wstats), wgrads = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1),
                                                        has_aux=True))(f0, f1)
    # The single-pair loss takes the key itself: split it as the step does
    # per pair, without the batch split.
    k_pos, k_n0, k_n1 = jax.random.split(key, 3)
    r = lambda k, n: torch.from_numpy(
        np.asarray(jax.random.randint(k, (256,), 0, 1 << 30)) % n)
    draws = ft.Draws(r(k_pos, 100), r(k_n0, n1), r(k_n1, n0))
    tf0, tf1 = (torch.from_numpy(a).requires_grad_() for a in (f0, f1))
    got, stats = ft.hardest_contrastive_loss(
        tf0, tf1, torch.from_numpy(xyz0), torch.from_numpy(xyz1), torch.from_numpy(T),
        torch.from_numpy(pos), 100, draws, LOSS_CFG)
    got.backward()
    stats = {k: float(v.detach()) for k, v in stats.items()}
    assert abs(float(got.detach()) - float(want)) <= LOSS_RTOL * abs(float(want))
    for k in ("pos_loss", "neg_loss", "d_pos_mean"):
        assert abs(stats[k] - float(wstats[k])) <= LOSS_RTOL * max(
            abs(float(wstats[k])), 1e-3), k
    for t, g in zip((tf0, tf1), wgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=0,
                                   atol=GRAD_RTOL * float(np.abs(g).max()))


@pytest.fixture(scope="module")
def fcgf_step():
    rng = np.random.RandomState(1)
    spec = jload("ResUNetBN2F")
    cfg = spec.make_config(1, 8, bn_momentum=0.05, conv1_kernel_size=3,
                           normalize_feature=True, D=3)
    params, state = numpy_tree(spec, cfg, rng)
    batch = jts.PairBatch(*map(jnp.asarray, pair_batch(rng, 2, 192, 64, span=7)))
    opt = jts.make_optimizer("SGD", 0.1, jax_config())
    _, loss_fn = jft.make_fcgf_train_step(spec, cfg, jft.FCGFLossConfig(*LOSS_CFG),
                                          opt, level_shrink=1)
    key = jax.random.PRNGKey(11)
    (loss, (new_state, stats)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params, state, key, batch)
    nb = PairBatch(*map(np.asarray, batch))
    return dict(tree=(params, state), batch=nb, loss=float(loss),
                stats=jax.tree.map(float, stats), grads=jax.tree.map(np.asarray, grads),
                new_state=jax.tree.map(np.asarray, new_state),
                draws=jax_draws(key, nb.pos_num, nb.num0, nb.num1, LOSS_CFG))


def _port(ref):
    spec = load_model("ResUNetBN2F")
    cfg = spec.make_config(1, 8, conv1_kernel_size=3, normalize_feature=True, D=3,
                           bn_momentum=0.05)
    net = spec.module(cfg)
    net.load_state_dict(convert.from_jax_params(*ref["tree"], cfg))
    opt = ts.make_optimizer("SGD", net.parameters(), default_config(lr=0.1))
    step, loss_fn = ft.make_fcgf_train_step(net.train(), LOSS_CFG, opt)
    return net, step, loss_fn, ts.batch_to(ref["batch"], "cpu")


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def test_fcgf_step_grads_match_jax(fcgf_step):
    net, _, loss_fn, batch = _port(fcgf_step)
    loss, stats = loss_fn(batch, fcgf_step["draws"])
    loss.backward()
    stats = {k: float(v.detach()) for k, v in stats.items()}
    for k, want in dict(fcgf_step["stats"], loss=fcgf_step["loss"]).items():
        assert abs(stats[k] - want) <= LOSS_RTOL * max(abs(want), 1e-3), k
    got = {k: p.grad.numpy() for k, p in net.named_parameters()}
    want = dict(_leaves(fcgf_step["grads"]))
    assert set(got) == set(want)
    for k, g in want.items():
        np.testing.assert_allclose(got[k], g, rtol=0, err_msg=k,
                                   atol=GRAD_RTOL * max(float(np.abs(g).max()), 1e-6))
    state = dict(_leaves(convert.to_jax_params(net)[1]))
    for k, v in _leaves(fcgf_step["new_state"]):
        np.testing.assert_allclose(state[k], v, atol=STATE_TOL, rtol=STATE_TOL, err_msg=k)


def test_fcgf_steps_lower_the_loss(fcgf_step):
    """Four port steps on the batch with fresh draws from a seeded
    generator: finite, and the loss falls."""
    _, step, loss_fn, batch = _port(fcgf_step)
    gen = torch.Generator().manual_seed(0)
    b = fcgf_step["batch"]
    draws = lambda: [ft.draw_indices(gen, b.pos_num[i], b.num0[i], b.num1[i], LOSS_CFG)
                     for i in range(2)]
    fixed = draws()
    with torch.no_grad():
        first = float(loss_fn(batch, fixed)[0])
    for _ in range(4):
        stats = step(batch, draws())
        assert stats["grad_finite"] and np.isfinite(float(stats["loss"]))
    with torch.no_grad():
        assert float(loss_fn(batch, fixed)[0]) < first
