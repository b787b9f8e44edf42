"""Port vs JAX package: voxelization, stride-down and the 3D plan's kernel maps.

Integer outputs must be equal: selected rows and their order, strided
grids, and every kernel map as an edge set (offset k, input row, output row)
— self, down and up maps at every level and the all-ones conv1 occupancy,
through both the JAX package's hash path and its dense-box path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepglobalregistration_tpu.models import unet_plan as jplan
from deepglobalregistration_tpu.ops import sparse_grid as jsg
from deepglobalregistration_tpu_torch.models import unet_plan
from deepglobalregistration_tpu_torch.ops import kernel_map, sparse_grid


def _cloud(seed, n=700, scale=1.0):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, 3) * scale - 0.3 * scale).astype(np.float32)


def test_voxelize_selects_the_same_rows_in_the_same_order():
    xyz = _cloud(0, 900)
    xyz = np.concatenate([xyz, xyz[::3]])  # duplicates inside voxels
    sel, grid = jax.jit(lambda x, n: jsg.voxelize(x, n, 0.05))(
        jnp.asarray(xyz), jnp.int32(len(xyz)))
    m = int(grid.num)
    p_sel, p_grid = sparse_grid.voxelize(torch.from_numpy(xyz), 0.05)
    assert p_grid.shape[0] == m
    np.testing.assert_array_equal(p_grid[:, 1:].numpy(), np.asarray(grid.coords)[:m])
    np.testing.assert_array_equal(p_sel.numpy(), np.asarray(sel)[:m])


@pytest.mark.parametrize("stride", [2, 4, 8])
def test_stride_down_matches(stride):
    coords = np.random.RandomState(1).randint(-40, 40, (500, 3)).astype(np.int32)
    g = jsg.stride_down(jsg.Grid(jnp.asarray(coords), jnp.int32(500)), stride)
    m = int(g.num)
    b = torch.zeros((500, 1), dtype=torch.int64)
    got = sparse_grid.stride_down(torch.cat([b, torch.from_numpy(coords).long()], 1),
                                  stride)
    np.testing.assert_array_equal(got[:, 1:].numpy(), np.asarray(g.coords)[:m])


def _edge_sets(em, row0_in, row0_out, n_in, n_out):
    """Edges of one cloud (rows local to it) from a port tile map."""
    t = em.tile
    slot = torch.arange(em.tile_in.shape[0])
    ok = (em.tile_in < em.n_in) & (em.tile_out < em.n_out)
    k = em.tile_k[slot // t][ok].tolist()
    i = (em.tile_in[ok] - row0_in).tolist()
    o = (em.tile_out[ok] - row0_out).tolist()
    return {(a, b, c) for a, b, c in zip(k, i, o)
            if 0 <= b < n_in and 0 <= c < n_out}


def _jax_edges(kmap, num_out):
    kmap = np.asarray(kmap)
    k, j = np.nonzero(kmap[:, :num_out] >= 0)
    return set(zip(k.tolist(), kmap[k, j].tolist(), j.tolist()))


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("ks", [3, 7])
def test_3d_plan_maps_equal_jax(dense, ks):
    clouds = [_cloud(2), _cloud(3, 650)]
    cap, levels = 1024, 4
    extent = (64, 64, 64) if dense else None
    xs = np.zeros((2, cap, 3), np.float32)
    for b, c in enumerate(clouds):
        xs[b, :len(c)] = c
    nums = jnp.asarray([len(c) for c in clouds], jnp.int32)
    _, grids = jax.vmap(lambda x, n: jsg.voxelize(x, n, 0.05))(jnp.asarray(xs), nums)
    build = jax.jit(jax.vmap(lambda g: jplan.build_unet_plan(
        g, ks, kernel_map.HYPER_CUBE, 3, levels, 2, dense_extent=extent,
        ones_input=True)))
    jp = build(grids)
    assert not bool(np.any(np.asarray(jp.overflow)))

    g0 = torch.cat([sparse_grid.voxelize(torch.from_numpy(c), 0.05, b)[1]
                    for b, c in enumerate(clouds)])
    pp = unet_plan.build_unet_plan(g0, 2, ks, kernel_map.HYPER_CUBE, levels,
                                   capacity=cap, level_shrink=2,
                                   dense_extent=extent, ones_input=True)
    assert pp.overflow == 0
    rows = [sparse_grid.counts(g, 2) for g in pp.grids]
    starts = [[0, r[0]] for r in rows]
    for b in range(2):
        for lvl in range(levels):
            n = rows[lvl][b]
            assert n == int(jp.grids[lvl].num[b])
            np.testing.assert_array_equal(
                pp.grids[lvl][starts[lvl][b]:starts[lvl][b] + n, 1:].numpy(),
                np.asarray(jp.grids[lvl].coords[b])[:n])
            assert _edge_sets(pp.selfs[lvl], starts[lvl][b], starts[lvl][b], n, n) \
                == _jax_edges(jp.self_kmaps[lvl][b], n)
        for lvl in range(levels - 1):
            nf, nc = rows[lvl][b], rows[lvl + 1][b]
            sf, sc = starts[lvl][b], starts[lvl + 1][b]
            assert _edge_sets(pp.downs[lvl], sf, sc, nf, nc) == \
                _jax_edges(jp.down_kmaps[lvl][b], nc)
            assert _edge_sets(pp.ups[lvl], sc, sf, nc, nf) == \
                _jax_edges(jp.up_kmaps[lvl][b], nf)
        n0 = rows[0][b]
        np.testing.assert_array_equal(
            pp.conv1_ones[starts[0][b]:starts[0][b] + n0].numpy(),
            np.asarray(jp.conv1_ones[b])[:n0].astype(np.float32))


def test_kernel_offsets_odometer_order_matches_jax():
    from deepglobalregistration_tpu.ops import kernel_map as jkm

    for ks, d, region in ((3, 3, 0), (7, 3, 0), (3, 6, 0), (3, 6, 1)):
        np.testing.assert_array_equal(kernel_map.kernel_offsets(ks, d, region),
                                      jkm.kernel_offsets(ks, d, region))


def test_key_span_too_wide_raises():
    from deepglobalregistration_tpu_torch.ops import hashing

    wide = torch.tensor([[0] * 6, [2 ** 20] * 6], dtype=torch.int64)
    with pytest.raises(ValueError, match="key bits"):
        hashing.KeyPacker(wide)
