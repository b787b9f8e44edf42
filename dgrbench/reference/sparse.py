"""Plain sparse voxel grids, kernel maps and convolutions.

The benchmark's own arithmetic, written from MinkowskiEngine's definitions
and not from the program under test:

- voxelize: one point per occupied voxel ``floor(xyz / voxel)``, the point
  with the smallest row index, voxels ordered by that index;
- a grid is an int64 matrix [N, 1 + D] (column 0 the cloud in the batch);
  level l of a U-Net holds the distinct ``floor(c / 2^l) * 2^l``;
- a kernel map links output row p to input row j through offset k when
  ``c_in[j] = c_out[p] + offset_k * unit``; a hyper-cube kernel lists its
  offsets with dimension 0 fastest (the order of the [K, Cin, Cout] weights);
- a convolution is ``out[p] = sum over edges (k, j, p) of x[j] @ W[k]``.

Lookups go through sorted mixed-radix int64 keys and ``torch.searchsorted``;
sums through ``index_add_``. Nothing here is fast; everything is exact.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# Bytes of the [rows, offsets, Cout] product block one convolution step holds.
_BLOCK_BYTES = 1 << 30


def voxelize(xyz: np.ndarray, voxel: float, arithmetic: str = "float32"):
    """(selected row indices [M] int64 in first-occurrence order, voxel
    coordinates [M, 3] int64) of a cloud [N, 3] float32. ``arithmetic`` is
    the precision of ``xyz / voxel`` (float32: MinkowskiEngine's
    ``sparse_quantize`` on float32 points; float64 where a data path states
    it)."""
    dt = np.dtype(arithmetic)
    coords = np.floor(np.asarray(xyz, np.float32).astype(dt) / dt.type(voxel)).astype(np.int64)
    _, first = np.unique(coords, axis=0, return_index=True)
    first = np.sort(first)
    return first, coords[first]


def hypercube_offsets(kernel_size: int, ndim: int) -> torch.Tensor:
    """[K, D] offsets of an odd cube, dimension 0 fastest."""
    r = kernel_size // 2
    k = torch.arange(kernel_size ** ndim)
    digits = [(k // kernel_size ** d) % kernel_size - r for d in range(ndim)]
    return torch.stack(digits, dim=1)


class KeyTable:
    """Sorted mixed-radix keys of a grid's rows, for exact row lookups."""

    def __init__(self, grid: torch.Tensor, margin: int):
        self.lo = grid.min(0).values - margin
        span = grid.max(0).values + margin - self.lo + 1
        radix = [1]
        for s in reversed(span.tolist()[1:]):
            radix.insert(0, radix[0] * int(s))
        if radix[0] * int(span[0]) >= 2 ** 62:
            raise ValueError(f"grid spans {span.tolist()} overflow an int64 key")
        self.hi = self.lo + span - 1
        self.radix = torch.tensor(radix, dtype=torch.int64, device=grid.device)
        keys = self.key(grid)[0]
        self.sorted, self.order = torch.sort(keys)

    def key(self, q: torch.Tensor):
        inside = torch.all((q >= self.lo) & (q <= self.hi), dim=-1)
        return torch.sum((q - self.lo) * self.radix, dim=-1), inside

    def find(self, q: torch.Tensor):
        """Row of the grid equal to each query row, and whether there is one."""
        k, inside = self.key(q)
        pos = torch.searchsorted(self.sorted, k).clamp_(max=self.sorted.numel() - 1)
        hit = inside & (self.sorted[pos] == k)
        return self.order[pos], hit


def stride_down(grid: torch.Tensor, stride: int) -> torch.Tensor:
    """Distinct rows of ``floor(c / stride) * stride`` (column 0 kept)."""
    snapped = grid.clone()
    snapped[:, 1:] = torch.div(grid[:, 1:], stride, rounding_mode="floor") * stride
    return torch.unique(snapped, dim=0)


class EdgeList(NamedTuple):
    """Edges (k, in row, out row) sorted by offset k."""

    k: torch.Tensor
    inp: torch.Tensor
    out: torch.Tensor
    n_in: int
    n_out: int
    n_offsets: int

    def transposed(self) -> "EdgeList":
        return EdgeList(self.k, self.out, self.inp, self.n_out, self.n_in,
                        self.n_offsets)


def kernel_map(in_grid: torch.Tensor, out_grid: torch.Tensor, offsets: torch.Tensor,
               unit: int) -> EdgeList:
    """Every edge from ``in_grid`` to ``out_grid`` through ``offsets`` x unit."""
    dev = in_grid.device
    margin = int(offsets.abs().max()) * unit
    table = KeyTable(in_grid, margin)
    off = torch.zeros((offsets.shape[0], in_grid.shape[1]), dtype=torch.int64,
                      device=dev)
    off[:, 1:] = offsets.to(dev) * unit
    ks, ins, outs = [], [], []
    rows = torch.arange(out_grid.shape[0], device=dev)
    step = max(1, (1 << 23) // max(out_grid.shape[0], 1))
    for s in range(0, off.shape[0], step):
        q = out_grid[None] + off[s:s + step, None]
        j, hit = table.find(q)
        kk, pp = torch.nonzero(hit, as_tuple=True)
        ks.append(kk + s)
        ins.append(j[kk, pp])
        outs.append(rows[pp])
    return EdgeList(torch.cat(ks), torch.cat(ins), torch.cat(outs),
                    in_grid.shape[0], out_grid.shape[0], off.shape[0])


def conv(x: torch.Tensor, weight: torch.Tensor, edges: EdgeList) -> torch.Tensor:
    """out[p] = sum of x[j] @ weight[k] over the edges (k, j, p); differentiable.

    Offsets are taken in blocks: one matmul gives every input row's product
    with each offset of the block, and the edges of the block pick theirs."""
    n_off, cin, cout = weight.shape
    out = x.new_zeros((edges.n_out, cout))
    per = max(1, _BLOCK_BYTES // max(1, 4 * x.shape[0] * cout))
    bounds = torch.searchsorted(edges.k, torch.arange(0, n_off + per, per,
                                                      device=edges.k.device)).tolist()
    for b, k0 in enumerate(range(0, n_off, per)):
        a, z = bounds[b], bounds[b + 1]
        if a == z:
            continue
        k1 = min(k0 + per, n_off)
        w = weight[k0:k1].permute(1, 0, 2).reshape(cin, (k1 - k0) * cout)
        y = (x @ w).view(x.shape[0], k1 - k0, cout)
        out = out.index_add(0, edges.out[a:z], y[edges.inp[a:z], edges.k[a:z] - k0])
    return out
