"""Port vs JAX package: ``register_batch(mesh=...)`` and ``train
--num_devices`` on two CPU ranks (``data_parallel.spawn``, gloo over a file
store, one PyTorch thread a rank).

- The fan-out of ``tests/test_torch_port_batch.py``'s three pairs over two
  ranks (padded to four by repeating pair 0): every rank returns the same
  poses; against the port's one-process ``register_batch(
  force_vmapped=True)`` T within 1e-5 (the ranks' sub-batches pad their
  pairs to other widths) and equal gate / ``cand_ok`` / rerun bits; against
  the JAX ``register_batch(mesh=make_mesh(2))`` at that file's atol 1e-3.
  With every pair failing the gate, rank 0 reruns them in pair order: bit
  for bit a fresh instance's ``register()`` calls.
- The trainer: ``train.main`` with ``--num_devices 2`` for one epoch of two
  steps (validation on rank 0) against ``--num_devices 1`` on the same
  loader: rank 0's checkpoint at 1e-4 of the largest leaf's |entry|, one
  checkpoint and one scalar stream, written by rank 0; with ``--iter_size
  2 --remat true`` each rank's trainer (``torch_port_ranks.
  trained_inlier``, what ``train.main`` runs on a rank) bit for bit the
  other's and at 1e-4 of the one process's; a batch that does not split
  over the ranks raises.
"""

import json
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from deepglobalregistration_tpu.config import default_config as jax_config
from deepglobalregistration_tpu.core.pipeline import DeepGlobalRegistration as JaxDGR
from deepglobalregistration_tpu.parallel import data_parallel as jdp
from deepglobalregistration_tpu_torch import train
from deepglobalregistration_tpu_torch.config import default_config
from deepglobalregistration_tpu_torch.core.pipeline import DeepGlobalRegistration
from deepglobalregistration_tpu_torch.parallel import data_parallel as dp
from deepglobalregistration_tpu_torch.tools.parallel_bench import fanout_rank
from deepglobalregistration_tpu_torch.utils import checkpoint
from deepglobalregistration_tpu_torch.utils.convert import from_jax_params, to_jax_params
from test_torch_port_batch import CFG, _batch_pairs
from torch_port_ranks import trained_inlier
from torch_port_trees import torch_threads

CPU2 = ["cpu", "cpu"]
BITS = ("gate", "cand_ok", "rerun")
SMALL = dict(dataset="SyntheticPairDataset", synthetic_points=3000, voxel_size=0.05,
             feat_model="ResUNetBN2F", feat_model_n_out=8, inlier_model="ResUNetBN2FX",
             batch_size=2, train_num_workers=0, val_num_workers=0, device="cpu",
             max_epoch=1, num_train_iter=2, val_max_iter=1, stat_freq=1,
             ckpt_dtype="f32", ckpt_compress="false", inlier_feature_type="coords")
# "coords": with the all-ones 6D input, conv1's channels are near-constant on
# these clouds and train-mode BN divides them by sqrt(eps), so the ranks'
# other summation order (1e-7) grows to 5e-6 of the largest leaf in one step
# and 8e-3 in two (tests/test_torch_port_train_step.py says the same of the
# JAX step); with "coords" two steps agree to 2.5e-7.


@pytest.fixture(scope="module", autouse=True)
def _one_thread_a_rank():
    with pytest.MonkeyPatch.context() as mp, torch_threads(1):
        mp.setenv("OMP_NUM_THREADS", "1")
        yield


def _leaves(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def test_fanout_matches_one_process_and_jax_mesh():
    jdgr = JaxDGR(jax_config(**CFG))
    xs, ys = _batch_pairs()
    nets = (from_jax_params(jdgr.fcgf_params, jdgr.fcgf_state, jdgr.fcgf_cfg),
            from_jax_params(jdgr.inlier_params, jdgr.inlier_state, jdgr.inlier_cfg))
    with ThreadPoolExecutor(1) as pool:  # the ranks run while JAX compiles
        ranks = pool.submit(dp.spawn, fanout_rank, 2, default_config(**CFG), xs, ys, 0,
                            nets, devices=CPU2)
        T_jax = jdgr.register_batch(xs, ys, mesh=jdp.make_mesh(2))
        ranks = ranks.result()
    dgr = DeepGlobalRegistration(default_config(**CFG), device="cpu")
    dgr.fcgf.load_state_dict(nets[0])
    dgr.inlier.load_state_dict(nets[1])
    T_one = dgr.register_batch(xs, ys, force_vmapped=True)
    T = ranks[0]["T"][0]
    assert T.shape == (3, 4, 4) and T.dtype == np.float64
    np.testing.assert_array_equal(ranks[1]["T"][0], T)
    for r in ranks:
        lb = r["last_batch"]
        for k in BITS:
            assert lb[k] == dgr.last_batch[k], k
        assert lb["gate"] == [True] * 3 and lb["rerun"] == [False] * 3
        assert lb["cap"] == [1024, 1024] and lb["icp_mode"] == ["full", "full"]
    np.testing.assert_allclose(T, T_one, atol=1e-5)
    np.testing.assert_allclose(T, T_jax, atol=1e-3)


def test_fanout_reruns_on_rank_0_in_pair_order():
    cfg = default_config(**dict(CFG, clip_weight_thresh=1.0))
    xs, ys = _batch_pairs()
    ranks = dp.spawn(fanout_rank, 2, cfg, xs, ys, devices=CPU2)
    fresh = DeepGlobalRegistration(cfg, device="cpu")
    want = np.stack([fresh.register(x, y) for x, y in zip(xs, ys)])
    assert fresh.last_branch == "ransac"
    for r in ranks:
        assert r["last_batch"]["rerun"] == [True] * 3
        np.testing.assert_array_equal(r["T"][0], want)


def _argv(out_dir, **kw):
    return [a for k, v in dict(SMALL, out_dir=str(out_dir), **kw).items()
            for a in (f"--{k}", str(v))]


def _gap(got, want) -> float:
    """The largest |got - want| of any leaf over the largest |want|."""
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert set(got) == set(want)
    scale = max(float(np.abs(v).max()) for v in want.values())
    return max(float(np.abs(got[k] - v).max()) for k, v in want.items()) / scale


def test_train_two_ranks_equals_one_process(tmp_path):
    """train.main --num_devices 2: rank 0's checkpoint (f32) against the
    one-process trainer's inlier net; one checkpoint and one scalar
    stream, written by rank 0."""
    run = tmp_path / "two"
    with ThreadPoolExecutor(1) as pool:  # the ranks train while one process does
        two = pool.submit(train.main, _argv(run, num_devices=2))
        one = train.main(_argv(tmp_path / "one", num_devices=1))
        assert two.result() is None
    saved = checkpoint.load_checkpoint(run / "checkpoint.pkl")["state_dict_inlier"]
    for part, want in enumerate(to_jax_params(one.inlier)):  # params, state
        gap = _gap(saved[("params", "state")[part]], want)
        assert gap <= 1e-4, (part, gap)
    keys = [sorted((e["tag"], e["step"]) for e in map(json.loads, (d / "scalars.jsonl").open()))
            for d in (run, tmp_path / "one")]
    assert keys[0] == keys[1]  # one writer: each scalar as often as one process writes it
    assert {"train/loss", "val/succ_rate"} <= {tag for tag, _ in keys[0]}
    files = [sorted(p.name.split(".")[0] for p in d.iterdir())
             for d in (run, tmp_path / "one")]
    assert files[0] == files[1]  # tensorboardX's event files too, where it imports
    assert files[0].count("checkpoint") == 1


def test_train_two_ranks_iter_size_remat_and_batch_split(tmp_path):
    """Gradients accumulated over two batches, then summed over the ranks
    once; with --remat, whose recomputed forward issues the BN all-reduces
    again in backward, on every rank alike: the ranks' inlier nets bit for
    bit, and within 1e-4 of the one-process trainer's."""
    kw = dict(iter_size=2, num_train_iter=1, remat="true", test_valid="false")
    with ThreadPoolExecutor(1) as pool:  # the ranks train while one process does
        ranks = pool.submit(dp.spawn, trained_inlier, 2,
                            _argv(tmp_path / "two", num_devices=2, **kw), devices=CPU2)
        one = train.main(_argv(tmp_path / "one", num_devices=1, **kw))
        ranks = ranks.result()
    for part, want in enumerate(to_jax_params(one.inlier)):  # params, state
        got = [dict(_leaves(r[part])) for r in ranks]
        for k in got[0]:
            np.testing.assert_array_equal(got[0][k], got[1][k], err_msg=k)
        gap = _gap(ranks[0][part], want)
        assert gap <= 1e-4, (part, gap)
    with pytest.raises(ValueError, match="batch_size 3 not divisible by num_devices 2"):
        train.main(_argv(tmp_path / "x", num_devices=2, batch_size=3))
