"""Port vs JAX package: ``register()`` end to end, plus the port's guards.

Whole slice: the configuration of tests/test_pipeline.py (ResUNetBN2F FCGF,
ResUNetBN2FX inlier net, 400-point clouds) with both nets carried from the
JAX instance; the transforms agree to atol 1e-3 and both take the same
branch of the weighted-sum gate.

Import guard: nothing in the port or chip_smoke.py imports jax, jaxlib,
optax or the JAX package. Device guard: without a card, the default device
raises instead of falling back to the CPU.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from deepglobalregistration_tpu.config import default_config as jax_config
from deepglobalregistration_tpu.core.pipeline import DeepGlobalRegistration as JaxDGR
from deepglobalregistration_tpu_torch.config import default_config
from deepglobalregistration_tpu_torch.core.pipeline import DeepGlobalRegistration
from deepglobalregistration_tpu_torch.utils.convert import from_jax_params

ROOT = Path(__file__).resolve().parent.parent
CFG = dict(feat_model="ResUNetBN2F", feat_model_n_out=8, feat_conv1_kernel_size=3,
           inlier_model="ResUNetBN2FX", inlier_conv1_kernel_size=3,
           voxel_size=0.05, inlier_feature_type="ones",
           point_buckets="512,1024", ransac_hypotheses=512, level_shrink=1)


@pytest.fixture(scope="module")
def pair_of_pipelines():
    jdgr = JaxDGR(jax_config(**CFG))
    dgr = DeepGlobalRegistration(default_config(**CFG), device="cpu")
    dgr.fcgf.load_state_dict(from_jax_params(jdgr.fcgf_params, jdgr.fcgf_state,
                                             jdgr.fcgf_cfg))
    dgr.inlier.load_state_dict(from_jax_params(jdgr.inlier_params,
                                               jdgr.inlier_state, jdgr.inlier_cfg))
    return jdgr, dgr


def _jax_register(jdgr, xyz0, xyz1):
    """The JAX package's fused register() program on one pair; returns
    (T, gate branch) — the same program register() dispatches."""
    import jax
    import jax.numpy as jnp

    from deepglobalregistration_tpu.core import pipeline as jp
    from deepglobalregistration_tpu.ops.sparse_grid import Grid

    cap = jp._bucket_for(max(len(xyz0), len(xyz1)), jdgr.buckets)
    pair = jnp.asarray(np.stack([jp._pad_cloud(xyz0, cap), jp._pad_cloud(xyz1, cap)]))
    sel, grids = jdgr._quantize(pair, jnp.asarray([len(xyz0), len(xyz1)], np.int32))
    nvox = np.asarray(grids.num)
    net = jp._bucket_for(int(nvox.max()), jdgr.buckets)
    out = jdgr._register_fused(jdgr.fcgf_params, jdgr.fcgf_state, jdgr.inlier_params,
                               jdgr.inlier_state, jax.random.PRNGKey(0),
                               sel[:, :net], Grid(grids.coords[:, :net], grids.num))
    T, wsum, ov3, ov6 = jax.device_get(out[:4])
    assert not (bool(ov3) or bool(ov6))
    branch = "refine" if float(wsum) >= max(200, 0.05 * int(nvox[0])) else "ransac"
    return np.asarray(T, np.float64), branch


@pytest.mark.parametrize("case", ["translation", "rotation"])
def test_register_matches_jax(pair_of_pipelines, case):
    jdgr, dgr = pair_of_pipelines
    rng = np.random.RandomState(0)
    xyz = (rng.rand(400, 3) * 1.2).astype(np.float32)
    if case == "translation":
        xyz1 = xyz + np.array([8, -8, 16], np.float32) * 0.05
    else:
        c, s = np.cos(0.1), np.sin(0.1)
        R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
        xyz1 = (xyz @ R.T + 0.02)[rng.permutation(400)][:380].astype(np.float32)
    T = dgr.register(xyz, xyz1)
    assert T.dtype == np.float64 and T.shape == (4, 4)
    T_jax, branch = _jax_register(jdgr, xyz, xyz1)
    np.testing.assert_allclose(T, T_jax, atol=1e-3)
    assert dgr.last_branch == branch
    assert dgr.overflow_count == 0


def test_register_many_is_register_in_a_loop(pair_of_pipelines):
    _, dgr = pair_of_pipelines
    rng = np.random.RandomState(1)
    a = (rng.rand(300, 3) * 1.2).astype(np.float32)
    b = a + np.float32(0.4)
    many = dgr.register_many([a, b], [b, a])
    np.testing.assert_array_equal(many[0], dgr.register(a, b))
    np.testing.assert_array_equal(many[1], dgr.register(b, a))


def test_gate_falls_back_to_seeded_ransac():
    """Weights all clipped to 0 fail the gate: register() takes RANSAC with
    draws from the instance's seeded generator, so it repeats exactly."""
    cfg = dict(CFG, clip_weight_thresh=1.0)
    rng = np.random.RandomState(2)
    a = (rng.rand(300, 3) * 1.2).astype(np.float32)
    Ts = []
    for _ in range(2):
        dgr = DeepGlobalRegistration(default_config(**cfg), device="cpu")
        Ts.append(dgr.register(a, a + np.float32(0.1)))
        assert dgr.last_branch == "ransac"
    assert np.isfinite(Ts[0]).all()
    np.testing.assert_array_equal(Ts[0], Ts[1])


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_and_chip_smoke_import_no_jax():
    files = sorted((ROOT / "deepglobalregistration_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    walked = {f.relative_to(ROOT).as_posix() for f in files}
    for path in ("ops/gather.py", "ops/icp.py", "ops/ransac.py", "ops/knn.py",
                 "tools/gather_bench.py", "tools/gather_sweep.py",
                 "tools/batch_bench.py",
                 "utils/synthetic.py", "core/pipeline.py",
                 "models/__init__.py", "models/simpleunet.py",
                 "models/pyramidnet.py", "utils/checkpoint.py",
                 "utils/fold_bn.py"):
        assert f"deepglobalregistration_tpu_torch/{path}" in walked
    banned = ("jax", "jaxlib", "optax", "deepglobalregistration_tpu")
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in banned, f"{f.relative_to(ROOT)} imports {mod}"


def test_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeepGlobalRegistration(default_config(**CFG))
