"""Port vs JAX package: the model registry, even kernels, the SP families'
pooling maps, per-cloud instance norm and the ResUNet families' forwards.

The registry holds the JAX package's 47 names. Integer outputs are equal:
the k2 offsets (3D and 6D) and the k2/s2 pooling maps and their transposes
as edge sets (offset k, input row, output row). Forwards run in f32 on two
clouds of a few hundred points with ``numpy_tree`` weights (BN live, with
non-trivial running statistics) and agree to atol 1e-4 (sums in another
order through up to five levels).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepglobalregistration_tpu.models import MODELS as JAX_MODELS
from deepglobalregistration_tpu.models import load_model as jload
from deepglobalregistration_tpu.ops import kernel_map as jkm
from deepglobalregistration_tpu.ops import sparse_conv as jsc
from deepglobalregistration_tpu_torch.models import MODELS, load_model, unet_plan
from deepglobalregistration_tpu_torch.ops import kernel_map, sparse_conv, sparse_grid
from torch_port_trees import forward_both, jax_grids, port_grid, random_clouds


def test_registry_names_equal_jax():
    assert list(MODELS) == list(JAX_MODELS)
    assert len(MODELS) == 47
    with pytest.raises(ValueError, match="not found"):
        load_model("ResUNetBN9")


@pytest.mark.parametrize("ndim", [3, 6])
def test_even_offsets_match_jax(ndim):
    np.testing.assert_array_equal(kernel_map.kernel_offsets(2, ndim),
                                  jkm.kernel_offsets(2, ndim))
    with pytest.raises(NotImplementedError):
        kernel_map.kernel_offsets(2, ndim, kernel_map.HYPER_CROSS)


def _edges(em, row0_in, row0_out, n_in, n_out):
    """Edges of one cloud (rows local to it) from a port tile map."""
    slot = torch.arange(em.tile_in.shape[0])
    ok = (em.tile_in < em.n_in) & (em.tile_out < em.n_out)
    k = em.tile_k[slot // em.tile][ok].tolist()
    i = (em.tile_in[ok] - row0_in).tolist()
    o = (em.tile_out[ok] - row0_out).tolist()
    return {e for e in zip(k, i, o) if 0 <= e[1] < n_in and 0 <= e[2] < n_out}


def _jax_edges(kmap, num_out):
    kmap = np.asarray(kmap)
    k, j = np.nonzero(kmap[:, :num_out] >= 0)
    return set(zip(k.tolist(), kmap[k, j].tolist(), j.tolist()))


@pytest.mark.parametrize("name,ndim", [("ResUNetBN2SPC", 3), ("ResUNetBNSPC", 6)])
def test_pool_maps_equal_jax(name, ndim):
    counts, cap = (300, 260), 512
    clouds = random_clouds(np.random.RandomState(1), counts, ndim, 14)
    jspec = jload(name)
    jcfg = jspec.make_config(1, 8, D=ndim)
    jp = jax.jit(lambda g: jax.vmap(jspec.build_plan, in_axes=(0, None, None))(
        g, jcfg, 1))(jax_grids(clouds, cap))
    assert not np.any(np.asarray(jp.overflow))
    cfg = load_model(name).make_config(1, 8, D=ndim)
    pp = unet_plan.build_unet_plan(port_grid(clouds), 2, 3, cfg.region_type,
                                   cfg.levels, with_pooling=True)
    assert len(pp.pool_downs) == len(jp.pool_down) == cfg.levels - 1
    rows = [sparse_grid.counts(g, 2) for g in pp.grids]
    for lvl in range(cfg.levels - 1):
        for b in range(2):
            nf, nc = rows[lvl][b], rows[lvl + 1][b]
            sf, sc = sum(rows[lvl][:b]), sum(rows[lvl + 1][:b])
            assert nc == int(jp.grids[lvl + 1].num[b])
            down = _jax_edges(jp.pool_down[lvl][b], nc)
            assert len(down) == nf  # every fine row has one parent
            assert _edges(pp.pool_downs[lvl], sf, sc, nf, nc) == down
            assert _edges(pp.pool_ups[lvl], sc, sf, nc, nf) == \
                _jax_edges(jp.pool_up[lvl][b], nf)


def test_instance_norm_is_per_cloud():
    rng = np.random.RandomState(2)
    counts = (120, 90)
    feats = [rng.randn(120, 5) * 0.5, rng.randn(90, 5) * 3.0 + 4.0]
    padded = np.zeros((2, 128, 5), np.float32)
    mask = np.zeros((2, 128), bool)
    for b, f in enumerate(feats):
        padded[b, :len(f)], mask[b, :len(f)] = f, True
    ref = jax.vmap(jsc.instance_norm)(jnp.asarray(padded), jnp.asarray(mask))
    ref = np.concatenate([np.asarray(ref[b])[:n] for b, n in enumerate(counts)])
    x = torch.from_numpy(np.concatenate(feats).astype(np.float32))
    batch = torch.repeat_interleave(torch.arange(2), torch.tensor(counts))
    got = sparse_conv.instance_norm(x, batch, 2).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    whole = sparse_conv.instance_norm(x, torch.zeros_like(batch), 1).numpy()
    assert np.abs(whole - ref).max() > 0.5  # one norm over the batch is wrong


@pytest.mark.parametrize("name,ndim", [
    ("ResUNetBN2Fv2", 3), ("ResUNetSP", 3), ("ResUNetBN2SPC", 3),
    ("ResUNetINBNSPC", 3), ("ResUNetBNSPC", 6)])
def test_resunet_forward_matches_jax(name, ndim):
    got, ref = forward_both(name, D=ndim)
    assert got.shape == ref.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=1e-4)
