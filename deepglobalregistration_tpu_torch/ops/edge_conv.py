"""Tile layout of an exact edge list, for the gather -> matmul -> slot-sum conv.

Counterpart of the JAX package's ``ops/edge_conv.py``. There, tiers, degree
sorts, per-row caps and live-edge budgets exist to give XLA static shapes
(and drop edges past them, raising the overflow flag). Here the edge list is
exact and variable-length; this module lays it out in tiles of ``tile``
edges that share one kernel offset, so a convolution is one gather of
[tiles, tile, Cin] rows, one batched matmul against each tile's [Cin, Cout]
kernel slice, and one fixed-order slot sum (``ops/slot_sum.py``, see
``ops/sparse_conv.py``). For that sum the map also lists each output row's
slots and each input row's, ascending: the JAX ``EdgeMap.out_slots``
(``edge_conv.py:48-66``) without its tiers, caps and degree sort.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .kernel_map import Edges

TILE = 128


class EdgeMap(NamedTuple):
    """Tile-blocked edges. Padding slots read input row ``n_in`` (a zero row
    the conv appends) and write output row ``n_out`` (a row it discards).
    Output row r's slots are ``out_slots[out_ptr[r]:out_ptr[r + 1]]`` and
    input row j's ``in_slots[in_ptr[j]:in_ptr[j + 1]]``, ascending; padding
    slots are in neither list. Tiles are sorted by offset, so a row's slots
    ascend with the offset."""

    tile_in: torch.Tensor   # [NT * T] int64
    tile_out: torch.Tensor  # [NT * T] int64
    tile_k: torch.Tensor    # [NT] int64
    n_in: int
    n_out: int
    n_edges: int
    tile: int
    out_ptr: torch.Tensor   # [n_out + 1] int32
    out_slots: torch.Tensor  # [E] int32
    in_ptr: torch.Tensor    # [n_in + 1] int32
    in_slots: torch.Tensor  # [E] int32


def row_slots(tile_rows: torch.Tensor, n_rows: int, n_edges: int):
    """(ptr [n_rows + 1] int32, slots [E] int32): each row's slots in
    ascending order, from the row of every slot (``tile_in`` or
    ``tile_out``; padding slots hold ``n_rows``, which a stable sort puts
    after the E real slots)."""
    if tile_rows.shape[0] >= 2 ** 31:
        raise ValueError(f"{tile_rows.shape[0]} slots: the slot lists are int32")
    order = torch.argsort(tile_rows, stable=True)
    bounds = torch.arange(n_rows + 1, device=tile_rows.device)
    ptr = torch.searchsorted(tile_rows[order], bounds).int()
    return ptr, order[:n_edges].int()


def build_edge_map(edges: Edges, tile: int = TILE) -> EdgeMap:
    """Lay an offset-sorted edge list out in single-offset tiles."""
    dev = edges.k.device
    e = edges.k.shape[0]
    cnt = torch.bincount(edges.k, minlength=edges.n_offsets)
    tiles_per_k = (cnt + tile - 1) // tile
    n_tiles = int(tiles_per_k.sum())
    tile_base = torch.cumsum(tiles_per_k, 0) - tiles_per_k
    edge_base = torch.cumsum(cnt, 0) - cnt
    order = torch.argsort(edges.k, stable=True)
    k = edges.k[order]
    slot = tile_base[k] * tile + (torch.arange(e, device=dev) - edge_base[k])
    tile_in = torch.full((n_tiles * tile,), edges.n_in, dtype=torch.int64, device=dev)
    tile_out = torch.full((n_tiles * tile,), edges.n_out, dtype=torch.int64, device=dev)
    tile_in[slot] = edges.inp[order]
    tile_out[slot] = edges.out[order]
    tile_k = torch.repeat_interleave(
        torch.arange(edges.n_offsets, device=dev), tiles_per_k)
    return EdgeMap(tile_in, tile_out, tile_k, edges.n_in, edges.n_out, e, tile,
                   *row_slots(tile_out, edges.n_out, e),
                   *row_slots(tile_in, edges.n_in, e))


def build_edge_maps(edges: Edges, tile: int = TILE):
    """(forward, transposed) tile maps of one edge list."""
    return build_edge_map(edges, tile), build_edge_map(edges.transpose(), tile)
