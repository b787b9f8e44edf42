"""Port vs JAX package: the ResUNetBN2C FCGF forward, and checkpoint loading.

Weights in the JAX package's layout (numpy-drawn, with non-trivial
BatchNorm statistics, folded as the pipeline folds them) are carried across with ``from_jax_params``; the
features of a two-cloud batch agree to atol 1e-4 in f32 (the sums run in
another order). The committed checkpoint must load to the same arrays as
the JAX package's loader, also in a process where ``ml_dtypes`` is absent.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from deepglobalregistration_tpu.models import load_model
from deepglobalregistration_tpu.ops import sparse_grid as jsg
from deepglobalregistration_tpu.utils import checkpoint as jckpt
from deepglobalregistration_tpu.utils.fold_bn import fold_batch_norms as jfold
from deepglobalregistration_tpu_torch.models import resunet, unet_plan
from deepglobalregistration_tpu_torch.ops import sparse_grid
from deepglobalregistration_tpu_torch.utils import checkpoint, convert, fold_bn
from torch_port_trees import numpy_tree

ROOT = Path(__file__).resolve().parent.parent
WEIGHTS = ROOT / "weights" / "fcgf_synthetic.pkl"


def test_resunet_bn2c_forward_matches_jax():
    rng = np.random.RandomState(0)
    clouds = [(rng.rand(n, 3) * 1.2).astype(np.float32) for n in (1500, 1400)]
    cap, extent = 2048, (64, 64, 64)
    spec = load_model("ResUNetBN2C")
    cfg = spec.make_config(1, 32, conv1_kernel_size=7, normalize_feature=True, D=3)
    p, s = numpy_tree(spec, cfg, rng)
    pf, sf, cfgf = jfold(p, s, cfg)

    xs = np.zeros((2, cap, 3), np.float32)
    for b, c in enumerate(clouds):
        xs[b, :len(c)] = c
    nums = jnp.asarray([len(c) for c in clouds], jnp.int32)

    @jax.jit
    def forward(xs, nums):
        _, grids = jax.vmap(lambda x, n: jsg.voxelize(x, n, 0.05))(xs, nums)
        plan = jax.vmap(spec.build_plan, in_axes=(0, None, None, None, None))(
            grids, cfgf, 2, extent, True)
        out, _ = spec.apply(pf, sf, cfgf, plan, jnp.ones((2, cap, 1)), train=False)
        return out, grids.num

    out, num = forward(jnp.asarray(xs), nums)
    ref = np.concatenate([np.asarray(out[b])[:int(num[b])] for b in range(2)])

    pcfg = resunet.make_config("ResUNetBN2C", 1, 32, conv1_kernel_size=7,
                               normalize_feature=True, D=3)
    pp, ps, pcfg = fold_bn.fold_batch_norms(p, s, pcfg)
    assert pcfg.norm_type == "NONE"
    net = resunet.ResUNet(pcfg).eval().requires_grad_(False)
    net.load_state_dict(convert.from_jax_params(pp, ps, pcfg))
    g0 = torch.cat([sparse_grid.voxelize(torch.from_numpy(c), 0.05, b)[1]
                    for b, c in enumerate(clouds)])
    plan = unet_plan.build_unet_plan(g0, 2, 7, pcfg.region_type, pcfg.levels,
                                     capacity=cap, dense_extent=extent,
                                     ones_input=True)
    got = net(plan, torch.ones((g0.shape[0], 1))).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_unfolded_batchnorm_matches_folded():
    """The port's live inference BN (fold_bn off) equals its folded form."""
    rng = np.random.RandomState(1)
    cfg = resunet.make_config("ResUNetBN2F", 1, 8, D=3)
    p, s = resunet.init_params(torch.Generator().manual_seed(3), cfg)
    s = {k: ({kk: vv + rng.rand(*vv.shape).astype(np.float32) for kk, vv in v.items()}
             if "mean" in v else v) for k, v in s.items()}
    live = resunet.ResUNet(cfg).eval().requires_grad_(False)
    live.load_state_dict(convert.from_jax_params(p, s, cfg))
    pf, sf, cf = fold_bn.fold_batch_norms(p, s, cfg)
    folded = resunet.ResUNet(cf).eval().requires_grad_(False)
    folded.load_state_dict(convert.from_jax_params(pf, sf, cf))
    _, g = sparse_grid.voxelize(torch.from_numpy(rng.rand(600, 3).astype(np.float32)),
                                0.05)
    plan = unet_plan.build_unet_plan(g, 1, 3, cfg.region_type, cfg.levels)
    x = torch.from_numpy(rng.rand(g.shape[0], 1).astype(np.float32))
    np.testing.assert_allclose(live(plan, x).numpy(), folded(plan, x).numpy(),
                               atol=1e-4)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    else:
        yield prefix, tree


def test_checkpoint_loads_like_the_jax_loader():
    ours = checkpoint.load_checkpoint(WEIGHTS)
    ref = jckpt.load_checkpoint(WEIGHTS)
    assert ours["config"] == ref["config"] and ours["state_dict_inlier"] is None
    a = dict(_leaves(ours["state_dict"]))
    b = dict(_leaves(ref["state_dict"]))
    assert a.keys() == b.keys() and len(a) > 50
    for k in a:
        assert a[k].dtype == np.float32
        np.testing.assert_array_equal(a[k], np.asarray(b[k]))


def test_checkpoint_loads_without_ml_dtypes():
    code = (
        "import sys; sys.modules['ml_dtypes'] = None\n"
        "from deepglobalregistration_tpu_torch.utils.checkpoint import load_checkpoint\n"
        f"s = load_checkpoint({str(WEIGHTS)!r})\n"
        "k = s['state_dict']['params']['conv1']['kernel']\n"
        "assert k.dtype.name == 'float32' and k.shape == (343, 1, 32), k.shape\n"
        "assert 'ml_dtypes' not in {m.split('.')[0] for m in sys.modules if sys.modules[m]}\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_from_jax_params_keys_match_the_module():
    cfg = resunet.make_config("ResUNetBN2C", 1, 32, conv1_kernel_size=7, D=3)
    p, s = resunet.init_params(torch.Generator().manual_seed(0), cfg)
    sd = convert.from_jax_params(p, s, cfg)
    assert set(sd) == set(resunet.ResUNet(cfg).state_dict())
    pf, sf, cf = fold_bn.fold_batch_norms(p, s, cfg)
    assert set(convert.from_jax_params(pf, sf, cf)) == \
        set(resunet.ResUNet(dataclasses.replace(cf)).state_dict())
