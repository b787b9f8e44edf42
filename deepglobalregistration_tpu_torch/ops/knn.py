"""Brute-force 1-nearest-neighbour search (squared L2) over rows of two matrices.

Counterpart of the JAX package's ``ops/knn.py:find_nn`` (the tiled running-
min scan) and ``ops/pallas_knn.py:find_nn_pallas`` (the fused TPU kernel).
Contract of both: for each of the first ``num0`` rows of F0, the index of the
nearest of the first ``num1`` rows of F1 and its squared distance
``|a|^2 - 2 a.b + |b|^2`` in f32; ties go to the lowest index; rows
``>= num0`` and queries with no candidate return ``(0, +inf)``.

``find_nn`` dispatches on the tensors' device: CUDA tensors go to the hand-
written kernel (``csrc/nn1.cu``) and nothing else; CPU tensors take the plain
PyTorch scan ``find_nn_plain``, which is also what ``chip_smoke.py`` holds the
kernel against on the card.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

_TILE = 4096
_MAX_C = 64


def _sq_norms(F: torch.Tensor) -> torch.Tensor:
    """Row |f|^2 as rounded squares summed in channel order (the kernel's
    order, so both sides' norms agree bit for bit)."""
    sq = torch.zeros(F.shape[0], dtype=F.dtype, device=F.device)
    for k in range(F.shape[1]):
        sq = sq + F[:, k] * F[:, k]
    return sq


def find_nn_plain(F0: torch.Tensor, F1: torch.Tensor, num0: int, num1: int,
                  tile: int = _TILE) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tiled running-min scan: the cross term per candidate tile from one f32
    ``torch.matmul``, masked columns at +inf, argmin (first index) per tile,
    and a strict '<' across tiles, so the lowest index wins every tie."""
    n0 = F0.shape[0]
    F0 = F0.float()
    F1 = F1[:num1].float()
    sq0 = _sq_norms(F0)
    sq1_all = _sq_norms(F1)
    best_d = torch.full((n0,), float("inf"), device=F0.device)
    best_i = torch.zeros((n0,), dtype=torch.int32, device=F0.device)
    for start in range(0, F1.shape[0], tile):
        f1 = F1[start:start + tile]
        sq1 = sq1_all[start:start + tile]
        d = sq0[:, None] - 2.0 * torch.matmul(F0, f1.T) + sq1[None, :]
        targ = torch.argmin(d, dim=1)
        tmin = torch.gather(d, 1, targ[:, None])[:, 0]
        upd = tmin < best_d
        best_d = torch.where(upd, tmin, best_d)
        best_i = torch.where(upd, (targ + start).to(torch.int32), best_i)
    valid = torch.arange(n0, device=F0.device) < num0
    return (torch.where(valid, best_i, torch.zeros_like(best_i)),
            torch.where(valid, best_d, torch.full_like(best_d, float("inf"))))


def _check(F0: torch.Tensor, F1: torch.Tensor, num0: int, num1: int) -> None:
    if F0.dim() != 2 or F1.dim() != 2 or F0.shape[1] != F1.shape[1]:
        raise ValueError(f"expected [N0, C] and [N1, C], got {tuple(F0.shape)} "
                         f"and {tuple(F1.shape)}")
    if not 0 < F0.shape[1] <= _MAX_C:
        raise ValueError(f"the 1-NN kernel takes 1 <= C <= {_MAX_C}, got "
                         f"C={F0.shape[1]}")
    if not (0 <= num0 <= F0.shape[0] and 0 <= num1 <= F1.shape[0]):
        raise ValueError(f"num0={num0} / num1={num1} outside the row counts "
                         f"{F0.shape[0]} / {F1.shape[0]}")
    for t in (F0, F1):
        if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("the 1-NN kernel takes contiguous float32 CUDA "
                             "tensors")
    if F0.device != F1.device:
        raise ValueError("F0 and F1 lie on different devices")


def _lib():
    from ..utils import cuda_build

    lib = cuda_build.load("nn1")
    if lib.dgr_nn1.argtypes is None:
        lib.dgr_nn1.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_void_p]
        lib.dgr_nn1.restype = ctypes.c_int
    return lib


def find_nn_cuda(F0: torch.Tensor, F1: torch.Tensor, num0: int, num1: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the hand-written 1-NN kernel on the current stream."""
    _check(F0, F1, num0, num1)
    n0, c = F0.shape
    idx = torch.empty((n0,), dtype=torch.int32, device=F0.device)
    d = torch.empty((n0,), dtype=torch.float32, device=F0.device)
    if n0 == 0:
        return idx, d
    lib = _lib()
    with torch.cuda.device(F0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dgr_nn1(F0.data_ptr(), F1.data_ptr(), n0, c, int(num0),
                          int(num1), idx.data_ptr(), d.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"nn1 kernel launch failed: CUDA error {err}")
    find_nn_cuda.launches += 1
    return idx, d


find_nn_cuda.launches = 0


def find_nn(F0: torch.Tensor, F1: torch.Tensor, num0: int | None = None,
            num1: int | None = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """1-NN of each F0 row among the first ``num1`` F1 rows.

    Returns (idx [N0] int32, d2 [N0] f32). CUDA tensors run the kernel (or
    raise); CPU tensors run the plain scan."""
    num0 = F0.shape[0] if num0 is None else int(num0)
    num1 = F1.shape[0] if num1 is None else int(num1)
    if F0.is_cuda or F1.is_cuda:
        return find_nn_cuda(F0.float().contiguous(), F1.float().contiguous(),
                            num0, num1)
    return find_nn_plain(F0, F1, num0, num1)


def find_knn_cpu(feat0, feat1, knn: int = 1, return_distance: bool = False):
    """Host KD-tree k-NN (scipy ``cKDTree``; the ``knn_search_method="cpu"``
    route, a copy of the JAX package's ``ops/knn.py:find_knn_cpu``). numpy in,
    numpy out: indices [N0] for knn = 1, else [N0, knn]."""
    from scipy.spatial import cKDTree

    dists, nn_inds = cKDTree(np.asarray(feat1)).query(np.asarray(feat0), k=knn)
    if return_distance:
        return nn_inds, dists
    return nn_inds
