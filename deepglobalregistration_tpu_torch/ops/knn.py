"""Brute-force 1-nearest-neighbour search (squared L2) over rows of two matrices.

Counterpart of the JAX package's ``ops/knn.py:find_nn`` (the tiled running-
min scan) and ``ops/pallas_knn.py:find_nn_pallas`` (the fused TPU kernel).
Contract of both: for each of the first ``num0`` rows of F0, the index of the
nearest of the first ``num1`` rows of F1 and its squared distance
``|a|^2 - 2 a.b + |b|^2`` in f32; ties go to the lowest index; rows
``>= num0`` and queries with no candidate return ``(0, +inf)``.

``find_nn`` dispatches on the tensors' device: CUDA tensors go to a hand-
written kernel and nothing else, chosen by the width C: ``nn1_scan``
(``csrc/nn1_scan.cu``, C <= 8: the ICP's xyz scan, a register-tiled scan on
the CUDA cores, bit for bit the plain version's arithmetic) or ``nn1_mma``
(``csrc/nn1_mma.cu``, 8 < C <= 64: the feature match, the cross term on the
tensor cores in 3xTF32, d2 within ``MMA_D2_RTOL`` of its exact value). CPU
tensors take the plain PyTorch scan ``find_nn_plain``, which is also what
``chip_smoke.py`` holds the kernels against on the card.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

_TILE = 4096
_MAX_C = 64
SCAN_MAX_C = 8  # widths up to this run kernel A (nn1_scan), wider ones kernel B
# Kernel B's d2 tolerance, of |a|^2 + |b|^2 against the exact value: 3xTF32
# drops the lo.lo product (2^-22 of |a||b|) and rounds in two f32
# accumulators; a CPU emulation at C = 32 showed 1.1-1.3 x 2^-22.
MMA_D2_RTOL = 2.0 ** -20


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


def _check(F0: torch.Tensor, F1: torch.Tensor, num0: int, num1: int,
           name: str, lo: int, hi: int) -> None:
    if F0.dim() != 2 or F1.dim() != 2 or F0.shape[1] != F1.shape[1]:
        raise ValueError(f"expected [N0, C] and [N1, C], got {tuple(F0.shape)} "
                         f"and {tuple(F1.shape)}")
    if not lo < F0.shape[1] <= hi:
        raise ValueError(f"{name} takes {lo} < C <= {hi}, got C={F0.shape[1]}")
    if not (0 <= num0 <= F0.shape[0] and 0 <= num1 <= F1.shape[0]):
        raise ValueError(f"num0={num0} / num1={num1} outside the row counts "
                         f"{F0.shape[0]} / {F1.shape[0]}")
    for t in (F0, F1):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous float32 tensors")


def _lib(name: str):
    from ..utils import cuda_build

    lib = cuda_build.load(name)
    launch = getattr(lib, f"dgr_{name}")
    workspace = getattr(lib, f"dgr_{name}_workspace")
    if launch.argtypes is None:
        launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_void_p]
        launch.restype = ctypes.c_int
        workspace.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
        workspace.restype = ctypes.c_longlong
    return launch, workspace


def _call(name: str, F0: torch.Tensor, F1: torch.Tensor, num0: int, num1: int,
          idx: torch.Tensor, d: torch.Tensor) -> None:
    """Launch ``csrc/<name>.cu`` on F0's device and current stream, with a
    workspace (the per-query merge keys and the packed candidates) from
    ``torch.empty``; raise on a CUDA error."""
    if not (F0.is_cuda and F1.is_cuda):
        raise ValueError("the 1-NN kernels take CUDA tensors")
    if F0.device != F1.device:
        raise ValueError("F0 and F1 lie on different devices")
    launch, workspace = _lib(name)
    n0, c = F0.shape
    ws = torch.empty((int(workspace(n0, c, num1)),), dtype=torch.uint8,
                     device=F0.device)
    with torch.cuda.device(F0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(F0.data_ptr(), F1.data_ptr(), n0, c, num0, num1,
                     ws.data_ptr(), idx.data_ptr(), d.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _run(name: str, lo: int, hi: int, F0: torch.Tensor, F1: torch.Tensor,
         num0: int, num1: int) -> Tuple[torch.Tensor, torch.Tensor, bool]:
    """Check, allocate the outputs, launch; the flag says whether it did."""
    _check(F0, F1, num0, num1, name, lo, hi)
    n0 = F0.shape[0]
    idx = torch.empty((n0,), dtype=torch.int32, device=F0.device)
    d = torch.empty((n0,), dtype=torch.float32, device=F0.device)
    if n0:
        _call(name, F0, F1, int(num0), int(num1), idx, d)
    return idx, d, n0 > 0


def nn1_scan(F0: torch.Tensor, F1: torch.Tensor, num0: int, num1: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel A (``csrc/nn1_scan.cu``, C <= 8): the register-tiled CUDA-core
    scan, equal to ``find_nn_plain`` bit for bit (d2 and index)."""
    idx, d, launched = _run("nn1_scan", 0, SCAN_MAX_C, F0, F1, num0, num1)
    nn1_scan.launches += launched
    return idx, d


def nn1_mma(F0: torch.Tensor, F1: torch.Tensor, num0: int, num1: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel B (``csrc/nn1_mma.cu``, 8 < C <= 64): the cross term on the
    tensor cores in 3xTF32. d2 lies within ``MMA_D2_RTOL`` (|a|^2 + |b|^2)
    of its exact value, so it may pick the other candidate of a near-tie."""
    idx, d, launched = _run("nn1_mma", SCAN_MAX_C, _MAX_C, F0, F1, num0, num1)
    nn1_mma.launches += launched
    return idx, d


def find_nn_cuda(F0: torch.Tensor, F1: torch.Tensor, num0: int, num1: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the hand-written 1-NN kernel for the rows' width on the current
    stream: ``nn1_scan`` for C <= 8, ``nn1_mma`` for 8 < C <= 64.
    ``find_nn_cuda.launches`` counts the launches of both."""
    c = F0.shape[-1]
    if not 0 < c <= _MAX_C:
        raise ValueError(f"the 1-NN kernels take 1 <= C <= {_MAX_C}, got C={c}")
    kernel = nn1_scan if c <= SCAN_MAX_C else nn1_mma
    idx, d = kernel(F0, F1, num0, num1)
    find_nn_cuda.launches += F0.shape[0] > 0
    return idx, d


nn1_scan.launches = nn1_mma.launches = find_nn_cuda.launches = 0


def find_nn(F0: torch.Tensor, F1: torch.Tensor, num0: int | None = None,
            num1: int | None = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """1-NN of each F0 row among the first ``num1`` F1 rows.

    Returns (idx [N0] int32, d2 [N0] f32). CUDA tensors run the kernel for
    their width (or raise); CPU tensors run the plain scan."""
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
