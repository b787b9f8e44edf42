"""Sparse voxel grids as exact variable-size coordinate sets.

Counterpart of the JAX package's ``ops/sparse_grid.py:45-86``. A grid here
is an int64 matrix [N, 1 + D]: column 0 is the cloud's index in the batch
(MinkowskiEngine's batched-coordinate convention), columns 1.. are voxel
coordinates in level-0 units. Rows of one cloud are contiguous and ordered
by first occurrence, so per-cloud row order equals the JAX package's.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import hashing


def voxelize(xyz: torch.Tensor, voxel_size: float, batch_index: int = 0
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One representative point per occupied voxel (the smallest row index).

    xyz [N, 3] f32. Returns (selected points [M, 3], grid [M, 4] with column
    0 = ``batch_index``)."""
    coords = torch.floor(xyz.float() / voxel_size).to(torch.int64)
    uniq, src = hashing.unique_rows(coords)
    b = torch.full((uniq.shape[0], 1), batch_index, dtype=torch.int64,
                   device=xyz.device)
    return xyz[src], torch.cat([b, uniq], dim=1)


def stride_down(grid: torch.Tensor, new_tensor_stride: int) -> torch.Tensor:
    """Distinct ``floor(c / s) * s`` of a grid's coordinates (s a power of two,
    where an arithmetic shift is floor division for negative values too)."""
    s = int(new_tensor_stride)
    if s & (s - 1):
        raise ValueError(f"tensor strides are powers of two, got {s}")
    k = s.bit_length() - 1
    snapped = torch.cat([grid[:, :1], (grid[:, 1:] >> k) << k], dim=1)
    return hashing.unique_rows(snapped)[0]


def counts(grid: torch.Tensor, batch_size: int) -> list[int]:
    """Rows per cloud of a batched grid."""
    return torch.bincount(grid[:, 0], minlength=batch_size).tolist()
