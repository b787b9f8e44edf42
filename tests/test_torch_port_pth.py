"""Port vs JAX package: the reference's ``.pth`` checkpoints.

A checkpoint in the reference trainer's schema ({epoch, state_dict,
state_dict_inlier, optimizer, scheduler, config, best_val, ...}) with
MinkowskiEngine names is written with ``torch.save`` from ``numpy_tree``
weights (non-trivial BN statistics) through the JAX package's own test
helper, for a small FCGF net and a small 6D inlier net. The port's
``load_torch_checkpoint`` gives the JAX package's trees leaf for leaf, and
its ``convert_state_dict`` gives back the trees the file was written from.
``register()`` from the file agrees with the JAX package's on a
well-conditioned pair (atol 1e-3, the same gate branch). A feature-only file gets a seeded random
inlier net and ``inlier_trained`` False in both packages.
"""

import numpy as np
import pytest
import torch

from deepglobalregistration_tpu.config import default_config as jax_config
from deepglobalregistration_tpu.core.pipeline import DeepGlobalRegistration as JaxDGR
from deepglobalregistration_tpu.models import load_model as jload
from deepglobalregistration_tpu.utils import checkpoint as jckpt
from deepglobalregistration_tpu_torch.config import default_config
from deepglobalregistration_tpu_torch.core.pipeline import DeepGlobalRegistration
from deepglobalregistration_tpu_torch.models import load_model
from deepglobalregistration_tpu_torch.utils import checkpoint, convert, device, fold_bn
from test_checkpoint import _me_style_state_dict
from test_torch_port_pipeline import _jax_register
from torch_port_trees import numpy_tree

NET = {"voxel_size": 0.05, "feat_model": "ResUNetBN2F", "feat_model_n_out": 8,
       "feat_conv1_kernel_size": 3, "normalize_feature": True,
       "inlier_model": "ResUNetBN2FX", "inlier_conv1_kernel_size": 3,
       "inlier_feature_type": "ones", "bn_momentum": 0.05}
RUN = dict(point_buckets="512,1024", ransac_hypotheses=512, level_shrink=1)


def _trees(seed):
    rng = np.random.RandomState(seed)
    fspec, ispec = jload(NET["feat_model"]), jload(NET["inlier_model"])
    fcgf = numpy_tree(fspec, fspec.make_config(1, 8, normalize_feature=True, D=3), rng)
    inlier = numpy_tree(ispec, ispec.make_config(1, 1, D=6), rng)
    return fcgf, inlier


def _write(path, fcgf, inlier):
    torch.save({"epoch": 100, "state_dict": _me_style_state_dict(*fcgf),
                "state_dict_inlier": None if inlier is None else
                _me_style_state_dict(*inlier),
                "optimizer": {}, "scheduler": {}, "config": dict(NET),
                "best_val": 0.9, "best_val_epoch": 77,
                "best_val_metric": "succ_rate"}, path)
    return str(path)


@pytest.fixture(scope="module")
def pth(tmp_path_factory):
    fcgf, inlier = _trees(0)
    d = tmp_path_factory.mktemp("pth")
    return {"trees": (fcgf, inlier), "full": _write(d / "dgr.pth", fcgf, inlier),
            "fcgf_only": _write(d / "fcgf.pth", fcgf, None)}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def test_load_torch_checkpoint_matches_jax(pth):
    ours = checkpoint.load_torch_checkpoint(pth["full"])
    ref = jckpt.load_torch_checkpoint(pth["full"])
    assert ours["config"] == ref["config"] and ours["epoch"] == 100
    for key in ("fcgf_params", "fcgf_state", "inlier_params", "inlier_state"):
        a, b = dict(_leaves(ours[key])), dict(_leaves(ref[key]))
        assert a.keys() == b.keys() and len(a) > 10
        for k in a:
            assert a[k].dtype == np.float32 and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k])
    only = checkpoint.load_torch_checkpoint(pth["fcgf_only"])
    assert "inlier_params" not in only and only["state_dict_inlier"] is None


@pytest.mark.parametrize("net", ["fcgf", "inlier"])
def test_convert_state_dict_inverts_the_reference_layout(pth, net):
    tree = pth["trees"][0 if net == "fcgf" else 1]
    sd = _me_style_state_dict(*tree)  # num_batches_tracked beside each mean
    for got, want in zip(checkpoint.convert_state_dict(sd), tree):
        got, want = dict(_leaves(got)), dict(_leaves(want))
        assert got.keys() == want.keys() and len(want) > 10
        for k in want:
            assert got[k].dtype == np.float32, k
            np.testing.assert_array_equal(got[k], want[k])


def test_register_from_pth_matches_jax(pth):
    jdgr = JaxDGR(jax_config(weights=pth["full"], **RUN))
    dgr = DeepGlobalRegistration(default_config(weights=pth["full"], **RUN),
                                 device="cpu")
    assert jdgr.inlier_trained and dgr.inlier_trained
    assert dgr.fcgf_cfg.name == "ResUNetBN2F" and dgr.inlier_cfg.D == 6
    rng = np.random.RandomState(0)
    xyz = (rng.rand(400, 3) * 1.2).astype(np.float32)
    xyz1 = xyz + np.array([8, -8, 16], np.float32) * 0.05
    T = dgr.register(xyz, xyz1)
    T_jax, branch = _jax_register(jdgr, xyz, xyz1)
    np.testing.assert_allclose(T, T_jax, atol=1e-3)
    assert dgr.last_branch == branch


def test_feature_only_pth_gets_a_seeded_inlier_net(pth):
    jdgr = JaxDGR(jax_config(weights=pth["fcgf_only"], **RUN))
    dgr = DeepGlobalRegistration(default_config(weights=pth["fcgf_only"], **RUN),
                                 device="cpu")
    assert not jdgr.inlier_trained and not dgr.inlier_trained
    spec = load_model(NET["inlier_model"])
    cfg = spec.make_config(1, 1, D=6)
    tree = fold_bn.fold_batch_norms(*spec.init_params(device.generator(1), cfg), cfg)
    want = convert.from_jax_params(*tree)
    got = dgr.inlier.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    full = DeepGlobalRegistration(default_config(weights=pth["full"], **RUN),
                                  device="cpu")
    for k, v in full.fcgf.state_dict().items():  # the same FCGF net either way
        assert torch.equal(dgr.fcgf.state_dict()[k], v), k
