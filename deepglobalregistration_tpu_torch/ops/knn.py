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

``find_nn_batched`` is the same search over B pairs [B, N, C] with per-pair
counts (the TPU kernel under ``vmap``): on the card one launch sequence of
the width's kernel for the whole batch (``nn1_scan_batched``,
``nn1_mma_batched``), each pair's result bit for bit that of its own
unbatched launch; on the CPU ``find_nn_plain`` pair by pair.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from ..utils import cuda_build

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


def find_nn_batched_plain(F0: torch.Tensor, F1: torch.Tensor, num0, num1
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``find_nn_plain`` pair by pair: F0 [B, N0, C], F1 [B, N1, C], counts
    [B]; returns (idx [B, N0] int32, d2 [B, N0] f32)."""
    n0s, n1s = _as_list(num0), _as_list(num1)
    idx = torch.zeros(F0.shape[:2], dtype=torch.int32, device=F0.device)
    d = torch.full(F0.shape[:2], float("inf"), device=F0.device)
    for b in range(F0.shape[0]):
        idx[b], d[b] = find_nn_plain(F0[b], F1[b], n0s[b], n1s[b])
    return idx, d


def _as_list(num) -> list:
    return num.tolist() if torch.is_tensor(num) else [int(n) for n in num]


def _check(F0: torch.Tensor, F1: torch.Tensor, name: str, lo: int, hi: int,
           batched: bool = False) -> None:
    rank, form = (3, "[B, N0, C] and [B, N1, C]") if batched else (2, "[N0, C] and [N1, C]")
    if (F0.dim() != rank or F1.dim() != rank or F0.shape[-1] != F1.shape[-1]
            or F0.shape[:-2] != F1.shape[:-2]):
        raise ValueError(f"expected {form}, got {tuple(F0.shape)} and "
                         f"{tuple(F1.shape)}")
    if not lo < F0.shape[-1] <= hi:
        raise ValueError(f"{name} takes {lo} < C <= {hi}, got C={F0.shape[-1]}")
    for t in (F0, F1):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous float32 tensors")


def _lib(name: str):
    lib = cuda_build.load(name)
    launch = getattr(lib, f"dgr_{name}")
    workspace = getattr(lib, f"dgr_{name}_workspace")
    if launch.argtypes is None:
        # launch.argtypes last: a thread that finds it set finds the rest set.
        launch.restype = ctypes.c_int
        workspace.argtypes = [ctypes.c_int] * 4
        workspace.restype = ctypes.c_longlong
        launch.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 6
                           + [ctypes.c_void_p] * 5)
    return launch, workspace


def _call(name: str, F0: torch.Tensor, F1: torch.Tensor, num0: int, num1: int,
          nums: torch.Tensor | None, idx: torch.Tensor, d: torch.Tensor) -> None:
    """Launch ``csrc/<name>.cu`` on F0's device and current stream, with a
    workspace (the per-query merge keys and the packed candidates) from
    ``torch.empty``; raise on a CUDA error. F0 [B, N0, C], F1 [B, N1, C];
    ``nums`` None: one pair (B = 1) with counts num0 / num1, else the
    per-pair counts [B, 2] int32 on the device."""
    if not (F0.is_cuda and F1.is_cuda):
        raise ValueError("the 1-NN kernels take CUDA tensors")
    if F0.device != F1.device or (nums is not None and nums.device != F0.device):
        raise ValueError("the 1-NN kernel's tensors lie on different devices")
    launch, workspace = _lib(name)
    b, n0, c = F0.shape
    n1 = F1.shape[1]
    rows1 = num1 if nums is None else n1  # candidates packed a pair
    ws = torch.empty((int(workspace(b, n0, c, rows1)),), dtype=torch.uint8,
                     device=F0.device)
    with torch.cuda.device(F0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(F0.data_ptr(), F1.data_ptr(), b, n0, n1, c, num0, num1,
                     None if nums is None else nums.data_ptr(), ws.data_ptr(),
                     idx.data_ptr(), d.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _run(name: str, lo: int, hi: int, F0: torch.Tensor, F1: torch.Tensor,
         num0: int, num1: int) -> Tuple[torch.Tensor, torch.Tensor, bool]:
    """Check, allocate the outputs, launch; the flag says whether it did."""
    _check(F0, F1, name, lo, hi)
    if not (0 <= num0 <= F0.shape[0] and 0 <= num1 <= F1.shape[0]):
        raise ValueError(f"num0={num0} / num1={num1} outside the row counts "
                         f"{F0.shape[0]} / {F1.shape[0]}")
    n0 = F0.shape[0]
    idx = torch.empty((n0,), dtype=torch.int32, device=F0.device)
    d = torch.empty((n0,), dtype=torch.float32, device=F0.device)
    if n0:
        _call(name, F0[None], F1[None], int(num0), int(num1), None, idx, d)
    return idx, d, n0 > 0


def _run_batched(name: str, lo: int, hi: int, F0: torch.Tensor,
                 F1: torch.Tensor, nums: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, bool]:
    """``_run`` for a batch: F0 [B, N0, C], F1 [B, N1, C], nums [B, 2] int32
    on the device (the kernel clamps each count to its pair's rows)."""
    _check(F0, F1, name, lo, hi, batched=True)
    b, n0 = F0.shape[:2]
    if nums.shape != (b, 2) or nums.dtype != torch.int32 or not nums.is_contiguous():
        raise ValueError(f"{name} takes counts [B, 2] int32, got "
                         f"{tuple(nums.shape)} {nums.dtype}")
    idx = torch.empty((b, n0), dtype=torch.int32, device=F0.device)
    d = torch.empty((b, n0), dtype=torch.float32, device=F0.device)
    launched = b > 0 and n0 > 0
    if launched:
        _call(name, F0, F1, 0, 0, nums, idx, d)
    return idx, d, launched


def nn1_scan(F0: torch.Tensor, F1: torch.Tensor, num0: int, num1: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel A (``csrc/nn1_scan.cu``, C <= 8): the register-tiled CUDA-core
    scan, equal to ``find_nn_plain`` bit for bit (d2 and index)."""
    idx, d, launched = _run("nn1_scan", 0, SCAN_MAX_C, F0, F1, num0, num1)
    cuda_build.count_launch(nn1_scan, launched)
    return idx, d


def nn1_mma(F0: torch.Tensor, F1: torch.Tensor, num0: int, num1: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel B (``csrc/nn1_mma.cu``, 8 < C <= 64): the cross term on the
    tensor cores in 3xTF32. d2 lies within ``MMA_D2_RTOL`` (|a|^2 + |b|^2)
    of its exact value, so it may pick the other candidate of a near-tie."""
    idx, d, launched = _run("nn1_mma", SCAN_MAX_C, _MAX_C, F0, F1, num0, num1)
    cuda_build.count_launch(nn1_mma, launched)
    return idx, d


def nn1_scan_batched(F0: torch.Tensor, F1: torch.Tensor, nums: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel A over a batch of pairs in one launch sequence: F0 [B, N0, C],
    F1 [B, N1, C] (C <= 8), nums [B, 2] int32 on the device. Each pair's
    (idx, d2) equal ``nn1_scan`` on that pair bit for bit."""
    idx, d, launched = _run_batched("nn1_scan", 0, SCAN_MAX_C, F0, F1, nums)
    cuda_build.count_launch(nn1_scan_batched, launched)
    return idx, d


def nn1_mma_batched(F0: torch.Tensor, F1: torch.Tensor, nums: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel B over a batch of pairs in one launch sequence (8 < C <= 64);
    each pair's (idx, d2) equal ``nn1_mma`` on that pair bit for bit."""
    idx, d, launched = _run_batched("nn1_mma", SCAN_MAX_C, _MAX_C, F0, F1, nums)
    cuda_build.count_launch(nn1_mma_batched, launched)
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
    cuda_build.count_launch(find_nn_cuda, F0.shape[0] > 0)
    return idx, d


nn1_scan.launches = nn1_mma.launches = find_nn_cuda.launches = 0
nn1_scan_batched.launches = nn1_mma_batched.launches = 0


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


def find_nn_xyz(xyz0: torch.Tensor, xyz1: torch.Tensor, num0: int | None = None,
                num1: int | None = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Spatial 1-NN of points [N, 3]: ``find_nn`` (on the card, ``nn1_scan``)."""
    return find_nn(xyz0, xyz1, num0, num1)


def pair_counts(num0, num1, device) -> torch.Tensor:
    """Per-pair counts [B, 2] int32 on ``device`` from two [B] sequences or
    int tensors (tensors already there are not copied)."""
    nums = [torch.as_tensor(n, device=device).reshape(-1) for n in (num0, num1)]
    return torch.stack(nums, dim=1).to(torch.int32).contiguous()


def find_nn_batched(F0: torch.Tensor, F1: torch.Tensor, num0, num1
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """1-NN of each pair's first ``num0[b]`` F0 rows among its first
    ``num1[b]`` F1 rows: F0 [B, N0, C], F1 [B, N1, C], counts [B] (ints or
    int tensors). Returns (idx [B, N0] int32, d2 [B, N0] f32); rows past
    ``num0[b]`` and queries with no candidate give (0, +inf).

    CUDA tensors run one batched launch of the width's kernel (or raise);
    CPU tensors run ``find_nn_plain`` pair by pair."""
    if F0.is_cuda or F1.is_cuda:
        c = F0.shape[-1]
        if not 0 < c <= _MAX_C:
            raise ValueError(f"the 1-NN kernels take 1 <= C <= {_MAX_C}, got C={c}")
        kernel = nn1_scan_batched if c <= SCAN_MAX_C else nn1_mma_batched
        return kernel(F0.float().contiguous(), F1.float().contiguous(),
                      pair_counts(num0, num1, F0.device))
    return find_nn_batched_plain(F0, F1, num0, num1)


def find_knn_cpu(feat0, feat1, knn: int = 1, return_distance: bool = False):
    """Host KD-tree k-NN (scipy ``cKDTree``; the ``knn_search_method="cpu"``
    route, a copy of the JAX package's ``ops/knn.py:find_knn_cpu``). numpy in,
    numpy out: indices [N0] for knn = 1, else [N0, knn]."""
    from scipy.spatial import cKDTree

    dists, nn_inds = cKDTree(np.asarray(feat1)).query(np.asarray(feat0), k=knn)
    if return_distance:
        return nn_inds, dists
    return nn_inds


def find_knn(F0: torch.Tensor, F1: torch.Tensor, num0: int, num1: int, k: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest of the first ``num1`` F1 rows (squared L2, ascending) for
    each F0 row [N0, C]: ``find_knn_batched`` on one pair. Returns (idx
    [N0, k] int64, d2 [N0, k] f32); rows past ``num0`` give (0, +inf), as
    the JAX package's ``find_knn``."""
    idx, d2 = find_knn_batched(F0[None], F1[None], [num0], [num1], k)
    valid = (torch.arange(F0.shape[0], device=F0.device) < num0)[:, None]
    return (torch.where(valid, idx[0], torch.zeros_like(idx[0])),
            torch.where(valid, d2[0], torch.full_like(d2[0], float("inf"))))


def find_knn_batched(F0: torch.Tensor, F1: torch.Tensor, num0, num1, k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest F1 rows (squared L2, ascending) of each F0 row, per pair:
    F0 [B, N0, C], F1 [B, N1, C], counts [B]. Returns (idx [B, N0, k] int64,
    d2 [B, N0, k] f32); candidates past ``num1[b]`` are never picked while
    the pair has k. The JAX package's ``knn.find_knn`` under ``vmap``
    (``inlier_knn > 1``), which is XLA there: here ``torch.topk`` over f32
    distance tiles of ``_TILE`` queries, on the tensors' device."""
    F0, F1 = F0.float(), F1.float()
    b, n0 = F0.shape[:2]
    sq1 = (F1 * F1).sum(-1)
    col = torch.arange(F1.shape[1], device=F1.device)
    n1 = torch.as_tensor(num1, device=F1.device).reshape(b, 1, 1)
    idx = torch.zeros((b, n0, k), dtype=torch.int64, device=F0.device)
    d2 = torch.zeros((b, n0, k), dtype=torch.float32, device=F0.device)
    for s in range(0, n0, _TILE):
        f0 = F0[:, s:s + _TILE]
        d = (f0 * f0).sum(-1, keepdim=True) - 2.0 * torch.bmm(f0, F1.transpose(1, 2)) \
            + sq1[:, None, :]
        d = torch.where(col < n1, d, torch.full_like(d, float("inf")))
        d2[:, s:s + _TILE], idx[:, s:s + _TILE] = torch.topk(d, k, dim=-1,
                                                             largest=False)
    return idx, d2
