"""Port vs JAX package: ``DeepGlobalRegistration(default_config())``.

Both packages default to a SimpleNetBN2C FCGF net with 16-D features and a
6D ResUNetBN2C inlier net at a 2.5 cm voxel, BN folded. The port builds them
through ``load_model``; with the JAX instance's nets carried across, a
well-conditioned pair (a translation) registers to the JAX transform within
atol 1e-3 on the same gate branch (the buckets and RANSAC budget are cut to
the test's 400-point clouds, as in ``tests/test_torch_port_pipeline.py``).
Without ``device=``, construction still raises when no card is visible.
"""

import numpy as np
import pytest
import torch

from deepglobalregistration_tpu.config import default_config as jax_config
from deepglobalregistration_tpu.core.pipeline import DeepGlobalRegistration as JaxDGR
from deepglobalregistration_tpu_torch.config import default_config
from deepglobalregistration_tpu_torch.core.pipeline import DeepGlobalRegistration
from deepglobalregistration_tpu_torch.utils.convert import from_jax_params
from test_torch_port_pipeline import _jax_register

RUN = dict(point_buckets="512,1024", ransac_hypotheses=512, level_shrink=1)


def test_default_config_registers_like_jax():
    jdgr = JaxDGR(jax_config(**RUN))
    dgr = DeepGlobalRegistration(default_config(**RUN), device="cpu")
    assert (dgr.fcgf_cfg.name, dgr.fcgf_cfg.out_channels, dgr.voxel_size) == \
        ("SimpleNetBN2C", 16, 0.025)
    assert dgr.fcgf_cfg.norm_type == jdgr.fcgf_cfg.norm_type == "NONE"
    dgr.fcgf.load_state_dict(from_jax_params(jdgr.fcgf_params, jdgr.fcgf_state,
                                             jdgr.fcgf_cfg))
    dgr.inlier.load_state_dict(from_jax_params(jdgr.inlier_params,
                                               jdgr.inlier_state, jdgr.inlier_cfg))
    rng = np.random.RandomState(0)
    xyz = (rng.rand(400, 3) * 1.2).astype(np.float32)
    xyz1 = xyz + np.array([8, -8, 16], np.float32) * 0.025
    T = dgr.register(xyz, xyz1)
    T_jax, branch = _jax_register(jdgr, xyz, xyz1)
    np.testing.assert_allclose(T, T_jax, atol=1e-3)
    assert dgr.last_branch == branch
    assert dgr.overflow_count == 0


def test_default_config_with_bn_live_runs_unfolded():
    dgr = DeepGlobalRegistration(default_config(fold_bn=False, **RUN), device="cpu")
    assert dgr.fcgf_cfg.norm_type == dgr.inlier_cfg.norm_type == "BN"
    rng = np.random.RandomState(1)
    xyz = (rng.rand(300, 3) * 1.2).astype(np.float32)
    assert np.isfinite(dgr.register(xyz, xyz + np.float32(0.1))).all()


def test_default_config_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeepGlobalRegistration(default_config())
