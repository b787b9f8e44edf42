"""Kernel offsets and exact kernel maps (edge lists) for sparse convolution.

Counterpart of the JAX package's ``ops/kernel_map.py:43-125``,
``ops/dense_grid.py:382-414`` and ``models/unet_plan.py:up_from_down``. The
JAX package builds padded [K, M] index maps through hash tables or a dense
box; here a map is the exact edge list (offset k, input row, output row):
output row p links to input row j through offset k iff
``coords_in[j] = coords_out[p] + offset_k * unit``. The lookup is a sorted
array of packed int64 keys plus ``torch.searchsorted``, so nothing is
dropped and no capacity applies.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import hashing

HYPER_CUBE = 0
HYPER_CROSS = 1

# Queries per searchsorted batch: bounds the [chunk, M, E] query tensors.
_MAX_QUERIES = 1 << 22


def kernel_offsets(kernel_size: int, ndim: int, region_type: int = HYPER_CUBE
                   ) -> np.ndarray:
    """[K, D] integer offsets of a kernel region (unit tensor stride).

    HYPER_CUBE enumerates the cube in odometer order with dimension 0
    FASTEST, MinkowskiEngine's order and the order of the [K, Cin, Cout]
    weights: another order silently scrambles trained kernels. An odd
    cube spans -r..r, an even one 0..k-1 (MinkowskiEngine's convention,
    used by the SP families' k2/s2 sum pooling). HYPER_CROSS lists the
    centre, then per dimension the offsets -r..-1, 1..r; it has no even
    form."""
    r = kernel_size // 2
    if region_type == HYPER_CUBE:
        lo, hi = (0, kernel_size - 1) if kernel_size % 2 == 0 else (-r, r)
        ranges = [np.arange(lo, hi + 1) for _ in range(ndim)]
        mesh = np.meshgrid(*reversed(ranges), indexing="ij")
        offs = np.stack([m.ravel() for m in reversed(mesh)], axis=1)
    elif region_type == HYPER_CROSS:
        if kernel_size % 2 == 0:
            raise NotImplementedError("even kernels only defined for HYPER_CUBE")
        rows = [np.zeros((1, ndim), np.int64)]
        for d in range(ndim):
            for step in list(range(-r, 0)) + list(range(1, r + 1)):
                row = np.zeros((1, ndim), np.int64)
                row[0, d] = step
                rows.append(row)
        offs = np.concatenate(rows, axis=0)
    else:
        raise ValueError(f"unknown region type {region_type}")
    return offs.astype(np.int64)


class Edges(NamedTuple):
    """Edge list of one convolution site, sorted by offset k."""

    k: torch.Tensor    # [E] int64 kernel offset index
    inp: torch.Tensor  # [E] int64 input row
    out: torch.Tensor  # [E] int64 output row
    n_in: int
    n_out: int
    n_offsets: int

    def transpose(self) -> "Edges":
        """The transposed convolution's map: the same edges with input and
        output exchanged at the same offset index (the up map is the scatter
        of the down map)."""
        return Edges(self.k, self.out, self.inp, self.n_out, self.n_in,
                     self.n_offsets)


def build_kernel_map(in_grid: torch.Tensor, out_grid: torch.Tensor,
                     offsets: np.ndarray, unit: int) -> Edges:
    """Exact map from an input grid to an output grid ([N, 1 + D] batched
    grids, column 0 the batch index) for ``offsets`` [K, D] times ``unit``."""
    dev = in_grid.device
    k_total = offsets.shape[0]
    n_in, n_out = in_grid.shape[0], out_grid.shape[0]
    empty = torch.zeros(0, dtype=torch.int64, device=dev)
    if n_in == 0 or n_out == 0:
        return Edges(empty, empty, empty, n_in, n_out, k_total)
    packer = hashing.KeyPacker(in_grid)
    keys, _ = packer.pack(in_grid)
    skeys, perm = torch.sort(keys)
    offs = torch.zeros((k_total, in_grid.shape[1]), dtype=torch.int64)
    offs[:, 1:] = torch.from_numpy(offsets) * int(unit)
    offs = offs.to(dev)
    chunk = max(1, _MAX_QUERIES // n_out)
    ks, ins, outs = [], [], []
    rows = torch.arange(n_out, device=dev)
    for s in range(0, k_total, chunk):
        q = out_grid[None, :, :] + offs[s:s + chunk, None, :]
        qk, ok = packer.pack(q)
        pos = torch.searchsorted(skeys, qk).clamp_(max=n_in - 1)
        hit = ok & (skeys[pos] == qk)
        kk, pp = torch.nonzero(hit, as_tuple=True)
        ks.append(kk + s)
        ins.append(perm[pos[kk, pp]])
        outs.append(rows[pp])
    return Edges(torch.cat(ks), torch.cat(ins), torch.cat(outs), n_in, n_out,
                 k_total)
