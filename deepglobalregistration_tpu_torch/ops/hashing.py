"""Exact integer keys for coordinate rows, and first-occurrence deduplication.

Counterpart of the JAX package's ``ops/hashing.py``. The JAX package hashes
into fixed-size bucket tables because XLA needs static shapes; here a row
packs exactly into one int64 key (each column offset by its minimum and
given just enough bits for its span), so sorting and ``torch.searchsorted``
give exact lookups. A set whose spans need more than 62 bits raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

_MAX_BITS = 62


class KeyPacker:
    """Packs rows of an int64 matrix [N, E] into int64 keys, column 0 most
    significant, so key order is the rows' lexicographic order.

    The packing covers the bounding box of ``coords`` widened by ``margin``
    per column; rows outside it have no key (``pack`` reports them)."""

    def __init__(self, coords: torch.Tensor, margin: int = 0):
        e = coords.shape[1]
        if coords.shape[0] == 0:
            lo = torch.zeros(e, dtype=torch.int64)
            hi = lo.clone()
        else:
            lo = coords.min(0).values.cpu() - margin
            hi = coords.max(0).values.cpu() + margin
        bits = [max(int(w) - 1, 0).bit_length() for w in (hi - lo + 1).tolist()]
        if sum(bits) > _MAX_BITS:
            raise ValueError(f"coordinate spans {(hi - lo + 1).tolist()} need "
                             f"{sum(bits)} key bits, more than {_MAX_BITS}")
        shifts, acc = [], 0
        for b in reversed(bits):
            shifts.append(acc)
            acc += b
        self.lo = lo.to(coords.device)
        self.hi = hi.to(coords.device)
        self.shifts = torch.tensor(list(reversed(shifts)), dtype=torch.int64,
                                   device=coords.device)

    def pack(self, q: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Keys of rows ``q`` [..., E] and whether each row lies in range."""
        ok = torch.all((q >= self.lo) & (q <= self.hi), dim=-1)
        keys = torch.sum((q - self.lo) << self.shifts, dim=-1)
        return keys, ok


def unique_rows(coords: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Distinct rows of ``coords`` [N, E], each represented by its SMALLEST
    original row index, ordered by that index (first occurrence) — the JAX
    package's ``unique_rows`` rule, not ``torch.unique``'s key order.

    Returns (unique rows [M, E], src [M] int64 original row of each)."""
    n = coords.shape[0]
    if n == 0:
        return coords, torch.zeros(0, dtype=torch.int64, device=coords.device)
    keys, _ = KeyPacker(coords).pack(coords)
    uniq, inv = torch.unique(keys, return_inverse=True)
    first = torch.full((uniq.shape[0],), n, dtype=torch.int64, device=coords.device)
    first.scatter_reduce_(0, inv, torch.arange(n, device=coords.device),
                          reduce="amin")
    src = torch.sort(first).values
    return coords[src], src
