"""Port vs JAX package: the SimpleNet and PyramidNet forwards, and BatchNorm
folding for every family.

Forwards as in ``tests/test_torch_port_models.py`` (f32, ``numpy_tree``
weights with non-trivial BN statistics, atol 1e-4). Folding: for every
registry entry with BN norms the port's folded forward equals its live-BN
forward (atol 1e-4); IN and INBN nets pass through unfolded. The JAX
package's fold marks a PyramidNet 'NONE' while its BNs stay unapplied, so
its folded PyramidNet differs from its own live-BN apply; the port's folded
PyramidNet equals the live-BN apply.
"""

import numpy as np
import pytest
import torch

from deepglobalregistration_tpu.models import load_model as jload
from deepglobalregistration_tpu.utils.fold_bn import fold_batch_norms as jfold
from deepglobalregistration_tpu_torch.models import MODELS, load_model, unet_plan
from deepglobalregistration_tpu_torch.ops import sparse_grid
from deepglobalregistration_tpu_torch.utils import convert, fold_bn
from torch_port_trees import forward_both, numpy_tree

NORMS = {n: load_model(n).make_config(1, 8).norm_type for n in MODELS}


@pytest.mark.parametrize("name", [
    "SimpleNetBNE", "SimpleNetINE", "SimpleNetBN2E", "SimpleNetBN3E",
    "PyramidNet", "PyramidNet6NoBlock", "PyramidNet6INBN"])
def test_forward_matches_jax(name):
    got, ref = forward_both(name)
    assert got.shape == ref.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=1e-4)


@pytest.fixture(scope="module")
def small_plan_input():
    rng = np.random.RandomState(3)
    grids = [sparse_grid.voxelize(torch.from_numpy((rng.rand(500, 3) * 1.2)
                                                   .astype(np.float32)), 0.05, b)[1]
             for b in range(2)]
    grid = torch.cat(grids)
    return grid, torch.from_numpy(rng.rand(grid.shape[0], 1).astype(np.float32))


@pytest.mark.parametrize("name", [n for n in MODELS if NORMS[n] == "BN"])
def test_folded_forward_equals_live_bn(name, small_plan_input):
    grid, x = small_plan_input
    spec = load_model(name)
    cfg = spec.make_config(1, 8, normalize_feature=True, D=3)
    jspec = jload(name)
    p, s = numpy_tree(jspec, jspec.make_config(1, 8, D=3), np.random.RandomState(4))
    live = spec.module(cfg).eval().requires_grad_(False)
    live.load_state_dict(convert.from_jax_params(p, s, cfg))
    pf, sf, cf = fold_bn.fold_batch_norms(p, s, cfg)
    assert cf.norm_type == "NONE"
    folded = spec.module(cf).eval().requires_grad_(False)
    folded.load_state_dict(convert.from_jax_params(pf, sf, cf))
    plan = unet_plan.build_unet_plan(grid, 2, 3, cfg.region_type, cfg.levels,
                                     with_pooling=cfg.with_pooling)
    np.testing.assert_allclose(folded(plan, x).numpy(), live(plan, x).numpy(),
                               atol=1e-4)


@pytest.mark.parametrize("name", [n for n in MODELS if NORMS[n] in ("IN", "INBN")])
def test_instance_norm_nets_pass_through_unfolded(name):
    spec = load_model(name)
    cfg = spec.make_config(1, 8, D=3)
    p, s = spec.init_params(torch.Generator().manual_seed(0), cfg)
    assert fold_bn.fold_batch_norms(p, s, cfg) == (p, s, cfg)


def test_pyramidnet_folded_keeps_the_bn_the_jax_fold_drops():
    jspec = jload("PyramidNet")
    jcfg = jspec.make_config(1, 8, D=3)
    p, s = numpy_tree(jspec, jcfg, np.random.RandomState(0))
    jp, _, jc = jfold(p, s, jcfg)
    # The JAX fault: 'NONE', yet the head conv got no bias and its BN is left.
    assert jc.norm_type == "NONE" and "bias" not in jp["conv"]["0"]
    assert jp["conv"]["1"]
    got, ref = forward_both("PyramidNet", port_fold=True)
    np.testing.assert_allclose(got, ref, atol=1e-4)
    _, jax_folded = forward_both("PyramidNet", jax_fold=True)
    assert np.abs(jax_folded - ref).max() > 1e-2
