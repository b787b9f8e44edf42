"""Ground-truth labels of predicted correspondences (the JAX package's
``core/correspondence.py``; reference core/correspondence.py:14-53).

A predicted pair (i, j) is correct when it is one of the pair's ground-truth
positive pairs. The JAX package tests membership through its coordinate
hash tables, widening indices past 32766 into two 16-bit fields. Here each
pair (i, j) is the exact int64 key ``i * 2^31 + j``, looked up by
``torch.searchsorted`` in the sorted keys of its own pair's positives, so
no index range is clamped.
"""

from __future__ import annotations

import numpy as np
import torch

_SHIFT = 31
_NONE = torch.iinfo(torch.int64).max  # the key of a padding positive


def _keys(pairs: torch.Tensor) -> torch.Tensor:
    pairs = pairs.long()
    return (pairs[..., 0] << _SHIFT) | pairs[..., 1]


def find_correct_correspondence(pos_pairs: torch.Tensor, pos_num, pred_pairs: torch.Tensor,
                                pred_num) -> torch.Tensor:
    """Membership of each predicted pair in its pair's positive set, for a
    batch: pos_pairs [B, P, 2] and pred_pairs [B, Q, 2] padded int index
    pairs, counts pos_num / pred_num [B]. Returns bool [B, Q]; padding rows
    are False."""
    dev = pred_pairs.device
    pos_num = torch.as_tensor(pos_num, device=dev).reshape(-1, 1)
    pred_num = torch.as_tensor(pred_num, device=dev).reshape(-1, 1)
    pos = _keys(pos_pairs)
    live = torch.arange(pos.shape[1], device=dev)[None] < pos_num
    table = torch.sort(torch.where(live, pos, torch.full_like(pos, _NONE)), dim=1).values
    q = _keys(pred_pairs)
    valid = torch.arange(q.shape[1], device=dev)[None] < pred_num
    if table.shape[1] == 0:
        return torch.zeros_like(valid)
    at = torch.searchsorted(table, q).clamp_max(table.shape[1] - 1)
    return (torch.gather(table, 1, at) == q) & valid


def find_correct_correspondence_np(pos_pairs: np.ndarray, pred_pairs: np.ndarray) -> np.ndarray:
    """Host oracle with the reference's hash formulation
    (core/correspondence.py:14-26), a copy of the JAX package's."""
    m = int(max(pos_pairs.max(initial=0), pred_pairs.max(initial=0)) + 1)
    pos_keys = pos_pairs[:, 0].astype(np.int64) + pos_pairs[:, 1].astype(np.int64) * m
    pred_keys = pred_pairs[:, 0].astype(np.int64) + pred_pairs[:, 1].astype(np.int64) * m
    return np.isin(pred_keys, pos_keys)
