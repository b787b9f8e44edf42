"""Port vs JAX package: the training step (``core/train_step.py``).

At the size of ``tests/test_training.py:_setup`` (FCGF ResUNetBN2F with 8
outputs, 6D inlier net ResUNetBN2FX, B = 2 pairs of ``N = 192`` padded
rows; ``torch_port_trees.pair_batch`` in a 7-voxel box), with weights drawn once by
``torch_port_trees.numpy_tree`` and carried to the port with
``from_jax_params``. The JAX step runs at ``level_shrink`` 1: at 2, its
192-row buffers cap pyramid level 1 at 128 rows, which drops rows of these
clouds without raising its overflow flag. The clouds are dense (~45 % of
the box's voxels): with an all-ones input, sparse random clouds give many
points identical features, whose exact 1-NN ties the two packages' f32
rounding (1e-7 apart) splits differently. The JAX side is compiled once for the
whole file: ``value_and_grad(loss_fn)`` and ``generate_inlier_input`` for
``inlier_knn`` 1 and 2 in one program.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepglobalregistration_tpu.config import default_config as jax_config
from deepglobalregistration_tpu.core import train_step as jts
from deepglobalregistration_tpu.models import load_model as jload
from deepglobalregistration_tpu_torch.config import default_config
from deepglobalregistration_tpu_torch.core import train_step as ts
from deepglobalregistration_tpu_torch.data.collate import PairBatch
from deepglobalregistration_tpu_torch.models import load_model
from deepglobalregistration_tpu_torch.utils import convert
from torch_port_trees import numpy_tree, pair_batch, torch_threads

CFG = dict(feat_model="ResUNetBN2F", feat_model_n_out=8, inlier_model="ResUNetBN2FX",
           inlier_feature_type="coords", lr=0.03)
# The 6D input is "coords" (cos of both points): with the all-ones input of
# the bench configuration, most rows of these small clouds share conv1's
# output, so train-mode BN divides near-constant channels by sqrt(eps) and
# both packages' f32 rounding (1e-7) grows to percent-level gradient gaps.
# Tolerances (f32 on both sides, sums in other orders through ~20 convs and
# BNs; measured gaps: loss 6e-8 relative, logits 2.6e-5, R 2.1e-6, t 5.5e-7,
# gradients 4.8e-5 of a leaf's largest): loss terms 1e-6 relative, logits
# 1e-4, R and t 1e-5, each gradient leaf 5e-4 of its largest |entry|, the new
# running statistics 1e-5.
LOSS_RTOL, LOGIT_ATOL, POSE_ATOL, GRAD_RTOL, STATE_TOL = 1e-6, 1e-4, 1e-5, 5e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def _nets(jf, jfs, ji, jis):
    """The port's frozen FCGF (eval) and inlier net (train) from JAX trees."""
    def build(name, cin, cout, k1, normalize, D, tree, train):
        spec = load_model(name)
        cfg = spec.make_config(cin, cout, conv1_kernel_size=k1,
                               normalize_feature=normalize, D=D, bn_momentum=0.05)
        net = spec.module(cfg)
        net.load_state_dict(convert.from_jax_params(*tree, cfg))
        return net.train(train).requires_grad_(train)

    return (build(CFG["feat_model"], 1, 8, 3, True, 3, (jf, jfs), False),
            build(CFG["inlier_model"], 6, 1, 3, False, 6, (ji, jis), True))


@pytest.fixture(scope="module")
def ref():
    """The JAX step's loss, stats, gradients and new BN state, and its
    generate_inlier_input for inlier_knn 1 and 2, on one batch."""
    rng = np.random.RandomState(0)
    config = jax_config(**CFG, level_shrink=1)
    fspec, ispec = jload(config.feat_model), jload(config.inlier_model)
    fcfg = fspec.make_config(1, 8, conv1_kernel_size=3, normalize_feature=True, D=3)
    icfg = ispec.make_config(6, 1, bn_momentum=0.05, conv1_kernel_size=3,
                             normalize_feature=False, D=6)
    fp, fs = numpy_tree(fspec, fcfg, rng)
    ip, is_ = numpy_tree(ispec, icfg, rng)
    batch = jts.PairBatch(*map(jnp.asarray, pair_batch(rng, 2, 192, 64, span=7)))
    opt = jts.make_optimizer("SGD", 1.0, config)
    _, loss_fn = jts.make_train_step(fspec, fcfg, ispec, icfg, config, opt)

    def program(ip, is_, fp, fs, batch):
        out = jax.value_and_grad(loss_fn, has_aux=True)(ip, is_, fp, fs, batch)
        gens = [jts.generate_inlier_input(fspec, fp, fs, fcfg, batch, "coords",
                                          inlier_knn=k, level_shrink=1)[:4]
                for k in (1, 2)]
        return out, gens

    ((loss, (new_state, stats)), grads), gens = jax.jit(program)(ip, is_, fp, fs, batch)
    to_np = lambda t: jax.tree.map(np.asarray, t)
    return dict(trees=(fp, fs, ip, is_), batch=PairBatch(*map(np.asarray, batch)),
                loss=float(loss), stats=to_np(stats), grads=to_np(grads),
                new_state=to_np(new_state), gens=to_np(gens))


def _port_step(ref, **overrides):
    fcgf, inlier = _nets(*ref["trees"])
    config = default_config(**CFG, device="cpu", **overrides)
    opt = ts.make_optimizer("SGD", inlier.parameters(), config)
    step, loss_fn = ts.make_train_step(fcgf, inlier, config, opt)
    return fcgf, inlier, opt, step, loss_fn, ts.batch_to(ref["batch"], "cpu")


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("knn", [1, 2])
def test_generate_inlier_input_matches_jax(ref, knn):
    coords6, ifeats, nn_idx, is_correct = ref["gens"][knn - 1]
    fcgf, _ = _nets(*ref["trees"])
    inp = ts.generate_inlier_input(fcgf, ts.batch_to(ref["batch"], "cpu"),
                                   CFG["inlier_feature_type"], inlier_knn=knn)
    valid = inp.valid.numpy()
    num0 = ref["batch"].num0 * knn
    np.testing.assert_array_equal(valid, np.arange(192 * knn)[None] < num0[:, None])
    np.testing.assert_array_equal(inp.nn_idx.numpy()[valid], nn_idx[valid])
    np.testing.assert_array_equal(inp.is_correct.numpy(), is_correct & valid)
    assert is_correct[valid].any() and not is_correct[valid].all()
    rows = inp.grid6.numpy()
    np.testing.assert_array_equal(rows[:, 1:], coords6[valid])
    np.testing.assert_array_equal(rows[:, 0], np.nonzero(valid)[0])
    np.testing.assert_allclose(inp.feats6.numpy(), ifeats[valid], atol=1e-6)


def test_loss_and_grads_match_jax(ref):
    _, inlier, _, _, loss_fn, batch = _port_step(ref)
    loss, stats = loss_fn(batch)
    loss.backward()
    stats = {k: v.detach() for k, v in stats.items()}
    js = ref["stats"]
    valid = js["valid"]
    np.testing.assert_array_equal(stats["valid"].numpy(), valid)
    np.testing.assert_array_equal(stats["labels"].numpy(), js["labels"])
    for key in ("loss", "pose_loss", "inlier_loss", "rot_err_deg", "trans_err"):
        want = float(js[key])
        assert abs(float(stats[key]) - want) <= LOSS_RTOL * max(1.0, abs(want)), key
    assert int(stats["valid_pairs"]) == int(js["valid_pairs"]) == 2
    np.testing.assert_allclose(stats["logits"].numpy()[valid],
                               js["logits"][valid], atol=LOGIT_ATOL)
    np.testing.assert_allclose(stats["R"].numpy(), js["R"], atol=POSE_ATOL)
    np.testing.assert_allclose(stats["t"].numpy(), js["t"], atol=POSE_ATOL)
    got = {k: p.grad.numpy() for k, p in inlier.named_parameters()}
    want = dict(_leaves(ref["grads"]))
    assert set(got) == set(want)
    for k, g in want.items():
        scale = max(float(np.abs(g).max()), 1e-6)
        np.testing.assert_allclose(got[k], g, atol=GRAD_RTOL * scale, rtol=0, err_msg=k)
    _, state = convert.to_jax_params(inlier)
    for k, v in _leaves(ref["new_state"]):
        np.testing.assert_allclose(dict(_leaves(state))[k], v, atol=STATE_TOL,
                                   rtol=STATE_TOL, err_msg=k)


def test_remat_grads_equal_plain(ref):
    grads, states = [], []
    for remat in (False, True):
        _, inlier, _, _, loss_fn, batch = _port_step(ref, remat=remat)
        loss, _ = loss_fn(batch)
        if remat:
            with ts.kept_bn_state(inlier):
                loss.backward()
        else:
            loss.backward()
        grads.append({k: p.grad.clone() for k, p in inlier.named_parameters()})
        states.append({k: b.clone() for k, b in inlier.named_buffers()})
    # Not bit for bit: two plain backwards on the CPU differ already (the
    # gathers' backward accumulates in a thread-dependent order), by up to
    # 4.8e-6 here; the running statistics come from the one forward each.
    for k in grads[0]:
        scale = float(grads[0][k].abs().max())
        assert float((grads[0][k] - grads[1][k]).abs().max()) <= 1e-4 * max(scale, 1e-6), k
    for k in states[0]:
        assert torch.equal(states[0][k], states[1][k]), k


def test_step_updates_and_nan_guard(ref):
    _, inlier, opt, step, _, batch = _port_step(ref)
    before = {k: p.detach().clone() for k, p in inlier.named_parameters()}
    stats = step(batch)
    assert stats["grad_finite"] is True
    assert any(not torch.equal(before[k], p) for k, p in inlier.named_parameters())
    # A non-finite input makes every gradient NaN: the step must leave the
    # parameters and the optimizer's momentum as they were.
    after = {k: p.detach().clone() for k, p in inlier.named_parameters()}
    mom = {k: opt.state[p]["momentum_buffer"].clone()
           for k, p in inlier.named_parameters()}
    bad = batch._replace(xyz1=torch.full_like(batch.xyz1, float("nan")))
    stats = step(bad)
    assert stats["grad_finite"] is False
    for k, p in inlier.named_parameters():
        assert torch.equal(after[k], p), k
        assert torch.equal(mom[k], opt.state[p]["momentum_buffer"]), k
