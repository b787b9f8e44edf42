"""The sparse conv's tile counters (``ops/sparse_conv.tile_counts``).

Each pass of a conv (forward, input gradient, kernel gradient) adds the
tile rows it launched (``tile_k.shape[0] * tile``) and the real edges among
them: one conv adds its map's counts to every pass it runs, a padding row
is a launched row that is no edge, and a net's counts are the sums over its
convs. Small grids on the CPU; a few seconds in all."""

import pytest
import torch

from deepglobalregistration_tpu_torch.models import load_model
from deepglobalregistration_tpu_torch.models.unet_plan import build_unet_plan
from deepglobalregistration_tpu_torch.ops import edge_conv, kernel_map
from deepglobalregistration_tpu_torch.ops import sparse_conv as sc
from deepglobalregistration_tpu_torch.utils import convert
from deepglobalregistration_tpu_torch.utils.device import generator

PASSES = ("forward", "dx", "dk")


def _read():
    return {p: (sc.tile_counts[p].tile_rows, sc.tile_counts[p].edges) for p in PASSES}


def _reset():
    for c in sc.tile_counts.values():
        c.reset()


def _grid(n, ndim, seed, span=9):
    gen = torch.Generator().manual_seed(seed)
    g = torch.unique(torch.randint(0, span, (n, ndim), generator=gen), dim=0)
    return torch.cat([torch.zeros_like(g[:, :1]), g], 1)


@pytest.mark.parametrize("ndim,tile", [(3, 16), (6, 128)])
def test_one_conv_adds_its_map_to_each_pass(ndim, tile):
    grid = _grid(300, ndim, ndim)
    offs = kernel_map.kernel_offsets(3, ndim)
    em = edge_conv.build_edge_map(kernel_map.build_kernel_map(grid, grid, offs, 1), tile)
    x = torch.randn(em.n_in, 4, requires_grad=True)
    w = torch.randn(len(offs), 4, 5, requires_grad=True)
    _reset()
    sc.sparse_conv(x, w, em).square().sum().backward()
    launched = em.tile_k.shape[0] * em.tile
    assert _read() == {p: (launched, em.n_edges) for p in PASSES}
    assert launched >= em.n_edges > 0
    # padding: every offset that has an edge takes whole tiles, less than
    # one tile of them padding
    per_k = torch.bincount(em.tile_k, minlength=len(offs)) * tile
    real_k = torch.bincount(em.tile_k.repeat_interleave(tile)[em.tile_in < em.n_in],
                            minlength=len(offs))
    assert int(per_k.sum()) == launched and int(real_k.sum()) == em.n_edges
    assert ((per_k - real_k) < tile).all()


def test_no_gradient_pass_without_a_gradient():
    grid = _grid(200, 3, 1)
    em = edge_conv.build_edge_map(kernel_map.build_kernel_map(
        grid, grid, kernel_map.kernel_offsets(3, 3), 1))
    _reset()
    with torch.no_grad():
        sc.sparse_conv(torch.randn(em.n_in, 2), torch.randn(27, 2, 3), em)
    assert _read()["dx"] == _read()["dk"] == (0, 0)
    assert _read()["forward"] == (em.tile_k.shape[0] * em.tile, em.n_edges)
    x = torch.randn(em.n_in, 2)  # a net's input: no input gradient
    _reset()
    sc.sparse_conv(x, torch.randn(27, 2, 3, requires_grad=True), em).sum().backward()
    assert _read()["dx"] == (0, 0) and _read()["dk"] == _read()["forward"]


def test_a_net_counts_every_conv():
    """A 3D ResUNetBN2F's train step: each pass's rows and edges are sums
    over the plan's maps, rows at least the edges, and padding is what the
    maps' tiles hold beyond their edges."""
    torch.manual_seed(0)
    spec = load_model("ResUNetBN2F")
    cfg = spec.make_config(1, 4, conv1_kernel_size=3, normalize_feature=False, D=3)
    net = spec.module(cfg)
    net.load_state_dict(convert.from_jax_params(*spec.init_params(generator(0), cfg), cfg))
    net.train()
    grid = _grid(500, 3, 7, span=14)
    plan = build_unet_plan(grid, 1, 3, cfg.region_type, cfg.levels)
    # conv1; two convs a block: encoder blocks 1-4 on levels 0-3, decoder
    # blocks 4_tr-2_tr on levels 2-0; conv2-conv4 down, conv4_tr-conv2_tr up
    uses = [plan.conv1] + [plan.selfs[lvl] for lvl in (0, 1, 2, 3, 2, 1, 0)
                           for _ in range(2)] + plan.downs + plan.ups
    want = (sum(m.tile_k.shape[0] * m.tile for m in uses), sum(m.n_edges for m in uses))
    _reset()
    net(plan, torch.ones((grid.shape[0], 1))).square().sum().backward()
    got = _read()
    assert got["forward"] == got["dk"] == want  # every conv's kernel takes a gradient
    first = (plan.conv1.tile_k.shape[0] * plan.conv1.tile, plan.conv1.n_edges)
    assert got["dx"] == (want[0] - first[0], want[1] - first[1])  # conv1's input takes none
    for p in PASSES:
        launched, edges = got[p]
        assert launched >= edges > 0, p
