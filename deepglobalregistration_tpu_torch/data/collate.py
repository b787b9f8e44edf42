"""Collation: per-pair tuples -> padded ``PairBatch`` (the JAX package's
``data/collate.py``; reference base_loader.py:40-98).

The reference collator concatenates variable-length clouds with batch-index
prefixes and per-pair ``len_batch``. The JAX package pads every pair to a
shared bucket capacity and stacks (its static shapes need that); the port
keeps the same ``PairBatch``, numpy on the host, so that batches and the
training slice's train step read alike in both packages. The reference's
dict keys are emitted beside it.
"""

from __future__ import annotations

import logging
from typing import NamedTuple, Sequence

import numpy as np


class PairBatch(NamedTuple):
    """A padded batch of registration pairs, numpy (leading axis = pairs);
    the JAX package's ``core/train_step.PairBatch``."""

    xyz0: np.ndarray  # [B, N, 3] f32 selected points per voxel
    xyz1: np.ndarray
    coords0: np.ndarray  # [B, N, 3] int32 voxel coords (padding 32766)
    coords1: np.ndarray
    num0: np.ndarray  # [B] int32
    num1: np.ndarray
    pos_pairs: np.ndarray  # [B, P, 2] int32 GT correspondence index pairs
    pos_num: np.ndarray  # [B] int32
    T_gt: np.ndarray  # [B, 4, 4] f32

_DEFAULT_BUCKETS = (2048, 4096, 8192, 16384, 32768, 65536, 131072)


def bucket_for(n: int, buckets: Sequence[int] = _DEFAULT_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"{n} exceeds largest bucket {buckets[-1]}")


def make_pair_batch(list_data, buckets: Sequence[int] = _DEFAULT_BUCKETS) -> PairBatch:
    """Stack per-pair 9-tuples into a padded PairBatch (numpy, host-side)."""
    xyz0, xyz1, c0, c1, f0, f1, matches, trans, _ = zip(*list_data)
    b = len(list_data)
    n = bucket_for(max(max(len(a) for a in xyz0), max(len(a) for a in xyz1)), buckets)
    # Ground-truth matches are kept whole: a radius search on a dense pair
    # emits up to ~1M, past the largest bucket. (The JAX package's static
    # shapes cut them at the largest bucket and label the rest negative; the
    # reference keeps every match, and so does the port.)
    max_matches = max(max(len(m) for m in matches), 1)
    p = bucket_for(max_matches, buckets) if max_matches <= buckets[-1] else max_matches

    def pad_pts(arrs):
        out = np.zeros((b, n, 3), np.float32)
        for i, a in enumerate(arrs):
            out[i, : len(a)] = a
        return out

    def pad_coords(arrs):
        out = np.full((b, n, 3), 32766, np.int32)
        for i, a in enumerate(arrs):
            out[i, : len(a)] = a
        return out

    pos = np.zeros((b, p, 2), np.int32)
    pos_num = np.zeros(b, np.int32)
    for i, m in enumerate(matches):
        if len(m):
            pos[i, :len(m)] = m
        pos_num[i] = len(m)

    return PairBatch(
        xyz0=pad_pts(xyz0), xyz1=pad_pts(xyz1),
        coords0=pad_coords(c0), coords1=pad_coords(c1),
        num0=np.array([len(a) for a in xyz0], np.int32),
        num1=np.array([len(a) for a in xyz1], np.int32),
        pos_pairs=pos, pos_num=pos_num,
        T_gt=np.stack(trans).astype(np.float32))


class CollationFunctionFactory:
    """Reference-compatible collator factory (base_loader.py:24-35)."""

    def __init__(self, concat_correspondences=True, collation_type="default",
                 buckets: Sequence[int] = _DEFAULT_BUCKETS):
        self.concat_correspondences = concat_correspondences
        self.buckets = buckets
        if collation_type == "default":
            self.collation_fn = self.collate_default
        elif collation_type == "collate_pair":
            self.collation_fn = self.collate_pair_fn
        else:
            raise ValueError(f"collation_type {collation_type} not found")

    def __call__(self, list_data):
        return self.collation_fn(list_data)

    def collate_default(self, list_data):
        return list_data

    def collate_pair_fn(self, list_data):
        n = len(list_data)
        list_data = [d for d in list_data if d is not None]
        if n != len(list_data):
            logging.info("Retain %d from %d data.", len(list_data), n)
        if not list_data:
            raise ValueError("No data in the batch")
        batch = make_pair_batch(list_data, self.buckets)
        xyz0, xyz1, c0, c1, f0, f1, matches, trans, extra = zip(*list_data)
        return {
            "pcd0": xyz0,
            "pcd1": xyz1,
            "correspondences": matches,
            "T_gt": batch.T_gt,
            "len_batch": [[len(a), len(b_)] for a, b_ in zip(xyz0, xyz1)],
            "extra_packages": extra,
            "pair_batch": batch,
        }
