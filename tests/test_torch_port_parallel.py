"""Port vs JAX package: data parallelism (``parallel/data_parallel.py``) and
the data-parallel train step, on two CPU ranks.

The ranks are processes of ``data_parallel.spawn`` (gloo over a file
store), each with one PyTorch thread (``OMP_NUM_THREADS=1``). The step runs
at ``tests/test_torch_port_train_step.py``'s size and setup (FCGF
ResUNetBN2F with 8 outputs, 6D ResUNetBN2FX, "coords" 6D input,
``torch_port_trees.pair_batch`` of B = 2 dense pairs, ``numpy_tree``
weights) and is held:

- against the port's one-process step on the whole batch (fed the ranks'
  1-NN indices): loss 1e-6 relative, BN running statistics 1e-5,
  gradients and updated parameters 1e-4 of the largest leaf's |entry|
  (the ranks sum BN moments and losses in another order); the ranks'
  parameters bit for bit after 3 steps;
- against the JAX step sharded over two of the conftest's virtual CPU
  devices (``make_sharded_train_step`` of ``value_and_grad(loss_fn)`` with
  ``make_mesh(2)``), at the train-step test's tolerances.

Below the step: the BCE losses with a class present on one rank only, and
train-mode BN with a rank that holds no row, against one process.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing

from deepglobalregistration_tpu.config import default_config as jax_config
from deepglobalregistration_tpu.core import train_step as jts
from deepglobalregistration_tpu.models import load_model as jload
from deepglobalregistration_tpu.parallel import data_parallel as jdp
from deepglobalregistration_tpu_torch.config import default_config
from deepglobalregistration_tpu_torch.data.collate import PairBatch
from deepglobalregistration_tpu_torch.ops import knn, losses, sparse_conv
from deepglobalregistration_tpu_torch.parallel import data_parallel as dp
from deepglobalregistration_tpu_torch.tools.parallel_bench import train_rank
from test_torch_port_train_step import (CFG, GRAD_RTOL, LOGIT_ATOL, LOSS_RTOL,
                                        POSE_ATOL, STATE_TOL)
from torch_port_ranks import pieces, raise_on_rank1
from torch_port_trees import numpy_tree, pair_batch, torch_threads

CPU2 = ["cpu", "cpu"]
STEP_RTOL = 1e-6  # loss, against the one-process step
LEAF_RTOL = 1e-4  # gradients and parameters, of the largest leaf's |entry|


@pytest.fixture(scope="module", autouse=True)
def _one_thread_a_rank():
    """One PyTorch thread here and in every rank (which reads
    OMP_NUM_THREADS when it starts)."""
    with pytest.MonkeyPatch.context() as mp, torch_threads(1):
        mp.setenv("OMP_NUM_THREADS", "1")
        yield


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _leaf_gap(got: dict, want: dict) -> float:
    """The largest |got - want| over the largest |want| of any leaf."""
    assert set(got) == set(want)
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want.values())
    return max(float(np.abs(np.asarray(got[k]) - np.asarray(want[k])).max())
               for k in want) / scale


def test_synthetic_pair_batch_equals_jax():
    got = dp.synthetic_pair_batch(np.random.RandomState(3), b=3, n=96, p=20)
    want = jdp.synthetic_pair_batch(np.random.RandomState(3), b=3, n=96, p=20)
    assert isinstance(got, PairBatch) and got._fields == want._fields
    for name, a, b in zip(got._fields, got, want):
        assert a.dtype == np.asarray(b).dtype, name
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)


def test_shard_batch_takes_the_rows_jax_places_on_each_device():
    batch = dp.synthetic_pair_batch(np.random.RandomState(0), b=4, n=64, p=8)
    jmesh = jdp.make_mesh(2)
    placed = jdp.shard_batch(jmesh, jts.PairBatch(*map(jnp.asarray, batch)))
    for r, dev in enumerate(jmesh.devices.flat):
        mine = dp.shard_batch(dp.Mesh(tuple(CPU2), "gloo", rank=r), batch)
        for name, a, j in zip(batch._fields, mine, placed):
            shard = [s for s in j.addressable_shards if s.device == dev]
            assert len(shard) == 1
            np.testing.assert_array_equal(a, np.asarray(shard[0].data), err_msg=name)
    with pytest.raises(ValueError, match="does not split"):
        dp.shard_batch(dp.Mesh(("cpu",) * 3, "gloo"), batch)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(0)
    config = jax_config(**CFG, level_shrink=1)
    fspec, ispec = jload(config.feat_model), jload(config.inlier_model)
    fcfg = fspec.make_config(1, 8, conv1_kernel_size=3, normalize_feature=True, D=3)
    icfg = ispec.make_config(6, 1, bn_momentum=0.05, conv1_kernel_size=3,
                             normalize_feature=False, D=6)
    trees = (numpy_tree(fspec, fcfg, rng), numpy_tree(ispec, icfg, rng))
    batch = PairBatch(*pair_batch(rng, 2, 192, 64, span=7))
    port_config = default_config(**CFG, device="cpu", bn_momentum=0.05)
    with ThreadPoolExecutor(1) as pool:  # the ranks run while JAX compiles
        ranks = pool.submit(dp.spawn, train_rank, 2, port_config, batch, 3, 0, None,
                            trees, devices=CPU2)
        jax_step = _jax_sharded_step(config, fspec, fcfg, ispec, icfg, trees, batch)
        ranks = ranks.result()
    return dict(trees=trees, batch=batch, config=port_config, ranks=ranks,
                jax_step=jax_step)


def _jax_sharded_step(config, fspec, fcfg, ispec, icfg, trees, batch):
    """The JAX step's loss, BN state, stats and gradients, sharded over two
    of the conftest's virtual CPU devices, as numpy."""
    (fp, fs), (ip, is_) = trees
    opt = jts.make_optimizer("SGD", 1.0, config)
    _, loss_fn = jts.make_train_step(fspec, fcfg, ispec, icfg, config, opt)
    grad_fn = jax.value_and_grad(loss_fn, has_aux=True)
    mesh = jdp.make_mesh(2)
    step = jdp.make_sharded_train_step(
        mesh, lambda p, s, o, f, g, b: grad_fn(p, s, f, g, b))
    batch = jdp.shard_batch(mesh, jts.PairBatch(*map(jnp.asarray, batch)))
    with mesh:
        out = step(*(jdp.replicate(mesh, t) for t in (ip, is_, (), fp, fs)), batch)
    return jax.tree.map(np.asarray, out)


def test_two_rank_step_equals_one_process(setup):
    r0, r1 = setup["ranks"]
    one = train_rank(None, setup["config"], setup["batch"], steps=1,
                     nn_idx=r0["stats"]["nn_idx"], trees=setup["trees"])
    for r in (r0, r1):
        assert [lc["nn1_mma_batched"] + lc["nn1_scan_batched"] for lc in r["launches"]] \
            == [0, 0, 0]  # the plain versions on the CPU
        assert r["grad_finite"] == [True] * 3 and np.isfinite(r["loss"]).all()
        assert abs(r["loss"][0] - one["loss"][0]) <= STEP_RTOL * abs(one["loss"][0])
        for k in ("labels", "valid", "nn_idx"):
            assert torch.equal(r["stats"][k], one["stats"][k]), k
        assert int(r["stats"]["valid_pairs"]) == int(one["stats"]["valid_pairs"]) == 2
        for k, v in one["buffers"].items():
            np.testing.assert_allclose(r["buffers"][k], v, atol=STATE_TOL,
                                       rtol=STATE_TOL, err_msg=k)
        assert r["ranks_agree"]  # parameters and BN statistics after 3 steps
    per = len(setup["batch"].num0) // 2
    for r, rank in enumerate((r0, r1)):  # each rank matched its own shard
        m = rank["match"]
        idx = knn.find_nn_batched(m["F0"], m["F1"], m["num0"], m["num1"])[0]
        assert torch.equal(idx.long(), r0["stats"]["nn_idx"][r * per:(r + 1) * per])
    assert _leaf_gap(r0["grads"], one["grads"]) <= LEAF_RTOL
    assert _leaf_gap(r0["params_first"], one["params_first"]) <= LEAF_RTOL
    assert r0["loss"] == r1["loss"]


def test_two_rank_step_equals_jax_sharded_step(setup):
    (loss, (new_state, stats)), grads = setup["jax_step"]
    r = setup["ranks"][0]
    got = r["stats"]
    assert abs(float(got["loss"]) - float(loss)) <= LOSS_RTOL * max(1.0, abs(float(loss)))
    for key in ("pose_loss", "inlier_loss", "rot_err_deg", "trans_err"):
        want = float(stats[key])
        assert abs(float(got[key]) - want) <= LOSS_RTOL * max(1.0, abs(want)), key
    valid = np.asarray(stats["valid"])
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    np.testing.assert_array_equal(got["labels"].numpy(), np.asarray(stats["labels"]))
    np.testing.assert_allclose(got["logits"].numpy()[valid],
                               np.asarray(stats["logits"])[valid], atol=LOGIT_ATOL)
    for k in ("R", "t"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(stats[k]), atol=POSE_ATOL)
    want = dict(_leaves(grads))
    assert set(want) == set(r["grads"])
    for k, g in want.items():
        scale = max(float(np.abs(g).max()), 1e-6)
        np.testing.assert_allclose(r["grads"][k].numpy(), g, atol=GRAD_RTOL * scale,
                                   rtol=0, err_msg=k)
    for k, v in _leaves(new_state):
        np.testing.assert_allclose(r["buffers"][k].numpy(), v, atol=STATE_TOL,
                                   rtol=STATE_TOL, err_msg=k)


def _loss_inputs():
    """A class present on rank 1 alone (rank 0's rows are all negatives)."""
    rng = np.random.RandomState(1)
    logits = rng.randn(40).astype(np.float32)
    labels = np.zeros(40, np.float32)
    labels[[25, 31, 33]] = 1.0
    mask = rng.rand(40) < 0.8
    mask[[25, 31]] = True
    return logits, labels, mask, [slice(0, 20), slice(20, 40)]


def _bn_inputs():
    """Rank 1 holds no row."""
    rng = np.random.RandomState(2)
    feats = (rng.randn(50, 6) * 2 + 1).astype(np.float32)
    weight = (1 + 0.2 * rng.randn(6)).astype(np.float32)
    bias = (0.1 * rng.randn(6)).astype(np.float32)
    return feats, weight, bias, [slice(0, 50), slice(50, 50)]


@pytest.fixture(scope="module")
def pieces_ranks():
    """The two tests below share one launch of two ranks."""
    return dp.spawn(pieces, 2, _loss_inputs(), _bn_inputs(), devices=CPU2)


def test_losses_take_global_counts_across_ranks(pieces_ranks):
    """A class present on rank 1 alone (rank 0's rows are all negatives):
    the balanced loss must still weigh it 1/2 on rank 0, from the global
    count; the ranks' shares and their gradients equal one process's."""
    logits, labels, mask, _ = _loss_inputs()
    ranks = [r["loss"] for r in pieces_ranks]
    for name, fn in (("balanced", losses.balanced_loss),
                     ("unbalanced", losses.unbalanced_loss)):
        x = torch.from_numpy(logits).requires_grad_(True)
        want = fn(x, torch.from_numpy(labels), torch.from_numpy(mask))
        want.backward()
        total, want = sum(r[name][0] for r in ranks), float(want.detach())
        assert abs(total - want) <= 1e-6 * abs(want), name
        grad = torch.cat([r[name][1] for r in ranks])
        np.testing.assert_allclose(grad.numpy(), x.grad.numpy(), atol=1e-7, err_msg=name)
    assert ranks[0]["balanced"][0] > 0  # rank 0 holds negatives only


def test_batch_norm_with_a_rank_without_rows(pieces_ranks):
    """Rank 1 holds no row: it still joins every collective (no deadlock),
    and rank 0's output, input gradient, the parameter gradients and both
    ranks' running statistics equal one process's over all rows."""
    feats, weight, bias, _ = _bn_inputs()
    ranks = [r["bn"] for r in pieces_ranks]
    x = torch.from_numpy(feats).requires_grad_(True)
    scale = torch.from_numpy(weight).requires_grad_(True)
    shift = torch.from_numpy(bias).requires_grad_(True)
    out, mean, var = sparse_conv.batch_norm_train(x, scale, shift, torch.zeros(6),
                                                  torch.ones(6), 0.1)
    (out * torch.linspace(-1, 1, 6)).sum().backward()
    assert ranks[1]["out"].shape == (0, 6)
    np.testing.assert_allclose(ranks[0]["out"].numpy(), out.detach().numpy(), atol=1e-5)
    np.testing.assert_allclose(ranks[0]["x_grad"].numpy(), x.grad.numpy(), atol=1e-5)
    for r in ranks:
        np.testing.assert_allclose(r["param_grad"].numpy(),
                                   torch.cat([scale.grad, shift.grad]).numpy(), atol=1e-4)
        np.testing.assert_allclose(r["mean"].numpy(), mean.numpy(), atol=1e-6)
        np.testing.assert_allclose(r["var"].numpy(), var.numpy(), rtol=1e-6)


def test_make_mesh_and_spawn_never_fall_back():
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        dp.make_mesh(2, devices=["cuda:0", "cuda:1"])
    with pytest.raises(RuntimeError, match="2 cards asked for, 0 visible"):
        dp.make_mesh(2)
    with pytest.raises(ValueError, match="NCCL needs a card"):
        dp.make_mesh(2, devices=CPU2, backend="nccl")
    assert dp.make_mesh(2, devices=CPU2) == dp.Mesh(("cpu", "cpu"), "gloo")
    with pytest.raises(torch.multiprocessing.ProcessRaisedException,
                       match="rank 1 fails on purpose"):
        dp.spawn(raise_on_rank1, 2, devices=CPU2)
