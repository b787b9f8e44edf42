"""Port vs JAX package: the 6D correspondence plan and the inlier net's logits.

On small 6D grids where the JAX package reports no overflow, every map of
``build_paired_unet_plan`` (conv1, self maps per level, down maps, and the
up maps derived from them) must equal the port's exact edge lists as sets
of (offset k, input row, output row). The inlier net (numpy-drawn weights
in the JAX layout, carried with ``from_jax_params``) gives logits within
atol 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepglobalregistration_tpu.models import load_model
from deepglobalregistration_tpu.models import unet_plan as jplan
from deepglobalregistration_tpu_torch.models import resunet, unet_plan
from deepglobalregistration_tpu_torch.utils import convert, fold_bn
from torch_port_trees import numpy_tree

N, CAP, LEVELS = 150, 256, 4


def _coords(seed):
    rng = np.random.RandomState(seed)
    c0 = np.unique(rng.randint(0, 14, size=(3 * N, 3)).astype(np.int32), axis=0)
    rng.shuffle(c0)
    c0 = c0[:N]
    c1 = rng.randint(0, 14, size=(N, 3)).astype(np.int32)
    pad = np.full((CAP - N, 3), 32766, np.int32)
    return np.concatenate([c0, pad]), np.concatenate([c1, pad])


def _port_grid(c0, c1):
    c6 = np.concatenate([np.zeros((N, 1), np.int64), c0[:N], c1[:N]], axis=1)
    return torch.from_numpy(c6.astype(np.int64))


def _port_edges(em):
    slot = torch.arange(em.tile_in.shape[0])
    ok = (em.tile_in < em.n_in) & (em.tile_out < em.n_out)
    return set(zip(em.tile_k[slot // em.tile][ok].tolist(),
                   em.tile_in[ok].tolist(), em.tile_out[ok].tolist()))


def _jax_edges(m, n_in, n_out):
    """Edges of a JAX tile map; maps with ``out_slots`` name each output
    row's tile slots there (rows degree-sorted, ``row_inv`` maps back)."""
    em = m.em
    k = np.asarray(em.tile_k)
    ti = np.asarray(em.tile_in)
    t = ti.shape[1]
    if em.out_slots is not None:
        slots = np.asarray(em.out_slots)[np.asarray(em.row_inv)[:n_out]]
        out = np.broadcast_to(np.arange(n_out)[:, None], slots.shape)
        ok = slots >= 0
        pos, out = slots[ok], out[ok]
    else:
        to = np.asarray(em.tile_out).ravel()
        pos = np.nonzero(to >= 0)[0]
        out = to[pos]
    kk, inp = k[pos // t], ti.ravel()[pos]
    ok = (kk >= 0) & (inp >= 0) & (inp < n_in) & (out < n_out)
    return set(zip(kk[ok].tolist(), inp[ok].tolist(), out[ok].tolist()))


@pytest.mark.parametrize("region", [0, 1])
def test_6d_plan_edges_equal_jax(region):
    c0, c1 = _coords(region)
    jp = jax.jit(lambda a, b: jplan.build_paired_unet_plan(
        a, b, jnp.int32(N), 3, region, LEVELS, 1))(jnp.asarray(c0), jnp.asarray(c1))
    assert not bool(jp.overflow)
    pp = unet_plan.build_unet_plan(_port_grid(c0, c1), 1, 3, region, LEVELS,
                                   capacity=CAP, level_shrink=1)
    assert pp.overflow == 0
    nums = [int(g.num) for g in jp.grids]
    assert nums == [g.shape[0] for g in pp.grids]
    for lvl in range(LEVELS):
        np.testing.assert_array_equal(pp.grids[lvl][:, 1:].numpy(),
                                      np.asarray(jp.grids[lvl].coords)[:nums[lvl]])
        assert _port_edges(pp.selfs[lvl]) == \
            _jax_edges(jp.self_kmaps[lvl], nums[lvl], nums[lvl])
    assert _port_edges(pp.conv1) == _jax_edges(jp.conv1_kmap, nums[0], nums[0])
    for lvl in range(LEVELS - 1):
        assert _port_edges(pp.downs[lvl]) == \
            _jax_edges(jp.down_kmaps[lvl], nums[lvl], nums[lvl + 1])
        assert _port_edges(pp.ups[lvl]) == \
            _jax_edges(jp.up_kmaps[lvl], nums[lvl + 1], nums[lvl])


def test_inlier_logits_match_jax():
    c0, c1 = _coords(5)
    spec = load_model("ResUNetBN2F")
    cfg = spec.make_config(1, 1, conv1_kernel_size=3, normalize_feature=False, D=6)
    rng = np.random.RandomState(0)
    p, s = numpy_tree(spec, cfg, rng, stats=0.1)
    feats = (300 * rng.rand(CAP, 1)).astype(np.float32)  # logits of order 1

    @jax.jit
    def logits(a, b, f):
        plan = jplan.build_paired_unet_plan(a, b, jnp.int32(N), 3, cfg.region_type,
                                            cfg.levels, 1)
        out, _ = spec.apply(p, s, cfg, jax.tree.map(lambda x: x[None], plan),
                            f[None], train=False)
        return out[0]

    ref = np.asarray(logits(jnp.asarray(c0), jnp.asarray(c1), jnp.asarray(feats)))[:N]
    pcfg = resunet.make_config("ResUNetBN2F", 1, 1, D=6)
    pp, ps, pcfg = fold_bn.fold_batch_norms(p, s, pcfg)
    net = resunet.ResUNet(pcfg).eval().requires_grad_(False)
    net.load_state_dict(convert.from_jax_params(pp, ps, pcfg))
    plan = unet_plan.build_unet_plan(_port_grid(c0, c1), 1, 3, pcfg.region_type,
                                     pcfg.levels)
    got = net(plan, torch.from_numpy(feats[:N])).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-3)
    assert np.abs(ref).max() > 0.1  # a live signal, not all-zero logits
