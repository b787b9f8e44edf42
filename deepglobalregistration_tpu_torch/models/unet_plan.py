"""Coordinate pyramid and exact kernel maps for U-Net-shaped sparse nets.

Counterpart of the JAX package's ``models/unet_plan.py:41-142``
(``build_unet_plan``, the 3D plan of every family) and ``:275-480``
(``build_paired_unet_plan``, the 6D inlier plan). One function builds both:
the 6D tiers, caps and budgets of the JAX package exist for XLA's static
shapes and have no counterpart here, because every map is an exact edge list.
With ``with_pooling`` it also builds the SP families' k2/s2 sum-pooling maps
(level i -> i + 1 over the even cube [0, 2)^D at unit 2^i, whatever the
net's region) and their transposes. The k1 convs of the sp3 family need no
map: a kernel-size-1 conv on its own grid is a plain product.

What the JAX package would have dropped is counted instead: a level holding
more rows than its capacity ``max(capacity // shrink**level, 128)``, or a
cloud whose span exceeds the ``dense_extent`` box, adds one to ``overflow``
(the port itself keeps every row and edge).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import torch

from ..ops import edge_conv, kernel_map, sparse_grid
from ..ops.edge_conv import EdgeMap


@dataclass
class UNetPlan:
    grids: List[torch.Tensor]            # per level [N_l, 1 + D]
    conv1: EdgeMap | None                # first conv's map (generic input)
    conv1_ones: torch.Tensor | None      # [N_0, K1] f32 occupancy (all-ones input)
    selfs: List[EdgeMap]                 # k3 stride-1 maps, one per level
    downs: List[EdgeMap]                 # level i -> i + 1
    ups: List[EdgeMap]                   # level i + 1 -> i (transposed downs)
    overflow: int                        # cloud-levels the JAX package would truncate
    batch_size: int                      # clouds in the batch (column 0's range)
    pool_downs: List[EdgeMap]            # k2/s2 sum pooling, level i -> i + 1
    pool_ups: List[EdgeMap]              # its transpose, level i + 1 -> i

    def seg(self, level: int):
        """(cloud index of each row, clouds) at ``level``: what a per-cloud
        norm needs."""
        return self.grids[level][:, 0], self.batch_size


def _occupancy(edges: kernel_map.Edges) -> torch.Tensor:
    occ = torch.zeros((edges.n_out, edges.n_offsets), dtype=torch.float32,
                      device=edges.k.device)
    occ[edges.out, edges.k] = 1.0
    return occ


def _box_overflow(grid: torch.Tensor, batch_size: int, level: int,
                  extent: Sequence[int], pad: int) -> int:
    """Clouds whose first three coordinates overrun the JAX package's dense
    box at this level (extent rounded up per level, plus its border)."""
    n = 0
    for b in range(batch_size):
        c = grid[grid[:, 0] == b][:, 1:4]
        if c.shape[0] == 0:
            continue
        span = ((c.max(0).values - c.min(0).values) >> level).tolist()
        ext = [max(-(-int(e) // (1 << level)), 1) for e in extent]
        n += any(s >= e + pad for s, e in zip(span, ext))
    return n


def build_unet_plan(grid0: torch.Tensor, batch_size: int, conv1_kernel_size: int,
                    region_type: int, n_levels: int, capacity: int | None = None,
                    level_shrink: int = 2, dense_extent: Sequence[int] | None = None,
                    ones_input: bool = False, with_pooling: bool = False) -> UNetPlan:
    """Pyramid (tensor strides 1, 2, .., 2^(L-1)) and every map of one batched
    grid [N, 1 + D]. ``capacity``/``level_shrink``/``dense_extent`` only feed
    the overflow count; the maps are exact regardless."""
    ndim = grid0.shape[1] - 1
    offs3 = kernel_map.kernel_offsets(3, ndim, region_type)
    offs1 = kernel_map.kernel_offsets(conv1_kernel_size, ndim, region_type)

    grids = [grid0]
    for level in range(1, n_levels):
        grids.append(sparse_grid.stride_down(grids[-1], 2 ** level))

    overflow = 0
    if capacity is not None:
        for level in range(1, n_levels):
            cap = max(capacity // (level_shrink ** level), 128)
            rows = sparse_grid.counts(grids[level], batch_size)
            overflow += sum(r > cap for r in rows)
    if dense_extent is not None:
        for level, g in enumerate(grids):
            pad = (conv1_kernel_size // 2 + 1) if level == 0 else 2
            if ndim == 6 and level == 0:
                pad = max(2, pad)
            overflow += _box_overflow(g, batch_size, level, dense_extent, pad)

    self_edges = [kernel_map.build_kernel_map(g, g, offs3, 2 ** i)
                  for i, g in enumerate(grids)]
    selfs = [edge_conv.build_edge_map(e) for e in self_edges]
    conv1 = conv1_ones = None
    if ones_input:
        conv1_ones = _occupancy(kernel_map.build_kernel_map(grid0, grid0, offs1, 1))
    elif conv1_kernel_size == 3:
        conv1 = selfs[0]
    else:
        conv1 = edge_conv.build_edge_map(
            kernel_map.build_kernel_map(grid0, grid0, offs1, 1))
    downs, ups = [], []
    for i in range(n_levels - 1):
        dn, up = edge_conv.build_edge_maps(
            kernel_map.build_kernel_map(grids[i], grids[i + 1], offs3, 2 ** i))
        downs.append(dn)
        ups.append(up)
    pool_downs, pool_ups = [], []
    if with_pooling:
        offs2 = kernel_map.kernel_offsets(2, ndim)
        for i in range(n_levels - 1):
            dn, up = edge_conv.build_edge_maps(
                kernel_map.build_kernel_map(grids[i], grids[i + 1], offs2, 2 ** i))
            pool_downs.append(dn)
            pool_ups.append(up)
    return UNetPlan(grids=grids, conv1=conv1, conv1_ones=conv1_ones, selfs=selfs,
                    downs=downs, ups=ups, overflow=int(overflow),
                    batch_size=batch_size, pool_downs=pool_downs,
                    pool_ups=pool_ups)

