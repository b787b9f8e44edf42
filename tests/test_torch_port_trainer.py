"""The port's trainer, ``train.main`` and checkpoint writing, on the CPU.

No JAX program is compiled here: the trainer runs the port alone (FCGF
ResUNetBN2F with 8 outputs, 6D ResUNetBN2FX, ``SyntheticPairDataset`` at 3000
points a cloud), and the JAX package appears only as a reader of the port's
checkpoints and, through ``jax.eval_shape``, as the source of the parameter
trees' structure.
"""

import json

import numpy as np
import pytest
import torch

from deepglobalregistration_tpu.models import load_model as jload
from deepglobalregistration_tpu.utils import checkpoint as jckpt
from deepglobalregistration_tpu_torch import train
from deepglobalregistration_tpu_torch.config import default_config
from deepglobalregistration_tpu_torch.core.pipeline import DeepGlobalRegistration
from deepglobalregistration_tpu_torch.core.trainer import WeightedProcrustesTrainer
from deepglobalregistration_tpu_torch.data.factory import make_data_loader
from deepglobalregistration_tpu_torch.models import load_model
from deepglobalregistration_tpu_torch.utils import checkpoint, convert
from deepglobalregistration_tpu_torch.utils.synthetic import synthetic_pair
from torch_port_trees import numpy_tree, torch_threads

SMALL = dict(dataset="SyntheticPairDataset", synthetic_points=3000, voxel_size=0.05,
             feat_model="ResUNetBN2F", feat_model_n_out=8, inlier_model="ResUNetBN2FX",
             batch_size=2, train_num_workers=0, val_num_workers=0, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def _argv(out_dir, **kw):
    args = dict(SMALL, out_dir=str(out_dir), **kw)
    return [a for k, v in args.items() for a in (f"--{k}", str(v))]


def _trainer(out_dir, **kw):
    config = default_config(**dict(SMALL, out_dir=str(out_dir), test_valid=False, **kw))
    loader = make_data_loader(config, "train", config.batch_size)
    return WeightedProcrustesTrainer(config, loader)


def _inlier_tree(trainer):
    return convert.to_jax_params(trainer.inlier)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def test_train_main_writes_logs_checkpoints_and_resumes(tmp_path):
    """train.main: scalars.jsonl with the JAX trainer's tags, config.json,
    checkpoint.pkl and best_val_checkpoint.pkl; then --resume_dir from an
    f32 uncompressed checkpoint restores epoch, nets and optimizer state bit
    for bit, and the checkpoint registers as a trained inlier net."""
    run = tmp_path / "run"
    trainer = train.main(_argv(run, max_epoch=1, num_train_iter=2, val_max_iter=1,
                               stat_freq=1, ckpt_dtype="f32", ckpt_compress="false",
                               ckpt_save_optimizer="true"))
    tags = {json.loads(line)["tag"] for line in (run / "scalars.jsonl").open()}
    for tag in ("train/loss", "train/f1", "train/hit_ratio", "train/precision",
                "val/succ_rate", "val/rte", "val/rre", "val/hit_ratio"):
        assert tag in tags, tag
    saved = json.loads((run / "config.json").read_text())
    assert saved["inlier_model"] == "ResUNetBN2FX" and saved["device"] == "cpu"
    assert (run / "checkpoint.pkl").exists() and (run / "best_val_checkpoint.pkl").exists()

    resumed = train.main(["--resume_dir", str(run), "--max_epoch", "1"])
    assert resumed.start_epoch == 1 and resumed.config.inlier_model == "ResUNetBN2FX"
    for (k, a), (_, b) in zip(_leaves(_inlier_tree(trainer)[0]),
                              _leaves(_inlier_tree(resumed)[0])):
        np.testing.assert_array_equal(a, b, err_msg=k)
    for (k, a), (_, b) in zip(_leaves(_inlier_tree(trainer)[1]),
                              _leaves(_inlier_tree(resumed)[1])):
        np.testing.assert_array_equal(a, b, err_msg=k)
    for p, q in zip(trainer.inlier.parameters(), resumed.inlier.parameters()):
        assert torch.equal(trainer.optimizer.state[p]["momentum_buffer"],
                           resumed.optimizer.state[q]["momentum_buffer"])

    dgr = DeepGlobalRegistration(default_config(weights=str(run / "checkpoint.pkl")),
                                 device="cpu")
    assert dgr.inlier_trained and dgr.inlier_cfg.name == "ResUNetBN2FX"
    xyz0, xyz1, _ = synthetic_pair(n=2000, seed=0)
    assert np.isfinite(dgr.register(xyz0, xyz1)).all()


def test_bf16_checkpoint_resumes_within_bf16(tmp_path):
    """The default storage (bf16, zlib): the resumed inlier net is the saved
    one rounded to bfloat16, and both packages' loaders read the same tree."""
    t = _trainer(tmp_path, max_epoch=1, num_train_iter=1)
    t.train()
    path = tmp_path / "checkpoint.pkl"
    assert path.read_bytes()[:4] == b"DGRZ"
    r = _trainer(tmp_path / "r", resume=str(path))
    assert r.start_epoch == 1
    for (k, a), (_, b) in zip(_leaves(_inlier_tree(t)[0]), _leaves(_inlier_tree(r)[0])):
        want = torch.from_numpy(a).to(torch.bfloat16).float().numpy()
        np.testing.assert_array_equal(b, want, err_msg=k)
        assert np.abs(b - a).max() <= 2 ** -8 * np.abs(a).max() + 1e-30, k
    jax_side = dict(_leaves(jckpt.load_checkpoint(path)["state_dict_inlier"]["params"]))
    port_side = dict(_leaves(checkpoint.load_checkpoint(path)["state_dict_inlier"]["params"]))
    assert set(jax_side) == set(port_side)
    for k, b in port_side.items():
        np.testing.assert_array_equal(np.asarray(jax_side[k], np.float32), b, err_msg=k)


def test_iter_size_averages_two_gradients(tmp_path):
    """iter_size=2 accumulates the mean of the two sub-batches' gradients
    before its one update (lr 0: the update leaves the weights)."""
    t = _trainer(tmp_path / "a", iter_size=2, num_train_iter=1, lr=0.0)
    t._train_epoch(0)
    got = {k: p.grad.clone() for k, p in t.inlier.named_parameters()}
    ref = _trainer(tmp_path / "b", lr=0.0)
    it = iter(ref.data_loader)
    grads = []
    for _ in range(2):
        ref.optimizer.zero_grad()
        ref.loss_fn(ref._batch(it))[0].backward()
        grads.append({k: p.grad.clone() for k, p in ref.inlier.named_parameters()})
    for k, g in got.items():
        want = (grads[0][k] + grads[1][k]) / 2
        # the CPU backward's own run-to-run spread is ~1e-6 of a leaf's max
        assert float((g - want).abs().max()) <= 1e-4 * max(float(want.abs().max()), 1e-6), k


def test_lr_decays_per_epoch_and_num_devices_raises(tmp_path):
    t = _trainer(tmp_path, max_epoch=3, num_train_iter=1, exp_gamma=0.5, lr=0.2)
    t.train()
    assert [t.epoch_lr(e) for e in range(3)] == [0.2, 0.1, 0.05]
    assert t.optimizer.param_groups[0]["lr"] == 0.05
    assert (tmp_path / "checkpoint.pkl").exists()
    with pytest.raises(ValueError, match="parallel"):
        _trainer(tmp_path / "x", num_devices=2)


def test_train_main_runs_on_the_card_unless_asked(tmp_path, monkeypatch):
    """No --device: the trainer asks for "cuda" and raises without a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in _argv(tmp_path) if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        train.main(argv)


@pytest.mark.parametrize("name", ["ResUNetBN", "ResUNetBN2C", "ResUNetBN2Cv2",
                                  "ResUNetBNSPC", "ResUNetBN2SPC", "ResUNetINBNSPC",
                                  "SimpleNetBN2C", "SimpleNetIN2", "PyramidNet6INBN"])
def test_to_jax_params_inverts_from_jax_params(name):
    """JAX tree -> module -> tree, bit for bit, for one net of each family
    (ResUNet v1_3, v1_4, v2, sp3, sp4, SimpleNet, PyramidNet; BN, IN, INBN)."""
    jspec = jload(name)
    jcfg = jspec.make_config(1, 16, conv1_kernel_size=3, normalize_feature=True, D=3)
    params, state = numpy_tree(jspec, jcfg, np.random.RandomState(0))
    spec = load_model(name)
    cfg = spec.make_config(1, 16, conv1_kernel_size=3, normalize_feature=True, D=3)
    net = spec.module(cfg)
    net.load_state_dict(convert.from_jax_params(params, state, cfg))
    p2, s2 = convert.to_jax_params(net)

    def same(a, b):
        assert isinstance(b, dict) == isinstance(a, dict)
        if isinstance(a, dict):
            assert set(a) == set(b)
            for k in a:
                same(a[k], b[k])
        else:
            assert b.dtype == np.float32 and np.array_equal(a, b)

    same(params, p2)
    same(state, s2)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_port_checkpoint_reads_in_both_packages(tmp_path, dtype):
    """save_checkpoint without ml_dtypes: the JAX package's load_checkpoint
    reads f32 trees exactly and bf16 trees as ml_dtypes' own rounding."""
    import ml_dtypes

    rng = np.random.RandomState(1)
    tree = {"conv1": {"kernel": rng.randn(27, 1, 8).astype(np.float32)},
            "norm1": {"weight": rng.randn(8).astype(np.float32)}, "empty": {}}
    state = {"norm1": {"mean": rng.randn(8).astype(np.float32)}}
    path = tmp_path / "c.pkl"
    checkpoint.save_checkpoint(path, epoch=4, params=tree, state=state,
                               inlier_params=tree, inlier_state=state,
                               config={"voxel_size": 0.05}, best_val=0.5,
                               dtype=dtype, compress=dtype == "bf16")
    for load in (jckpt.load_checkpoint, checkpoint.load_checkpoint):
        out = load(path)
        assert out["epoch"] == 4 and out["best_val"] == 0.5
        assert out["config"] == {"voxel_size": 0.05}
        for part, src in (("params", tree), ("state", state)):
            got = dict(_leaves(out["state_dict_inlier"][part]))
            for k, v in _leaves(src):
                want = v if dtype == "f32" else \
                    v.astype(ml_dtypes.bfloat16).astype(np.float32)
                np.testing.assert_array_equal(np.asarray(got[k], np.float32), want,
                                              err_msg=k)
        assert out["state_dict"]["params"]["empty"] == {}
