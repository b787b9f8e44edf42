"""Flat int32 gather ``out[i] = table[idx[i]]`` from a table of W words.

Counterpart of the JAX package's gather probe ``tools/pallas_gather_bench.py``:
``take`` replaces ``pallas_take`` (a flat take from a table held whole in
VMEM) and ``take2d`` replaces ``pallas_take2d`` (a row gather
``table2d[idx >> 7]`` followed by the lane select ``idx & 127`` from the same
table viewed as [W / 128, 128]). Both kernels are in ``csrc/gather.cu``.

Contract of both: ``idx`` holds int32 values in ``[0, W)``. The kernels do
not check it (an index outside the table reads outside it), as the probe
gives them in-range indices only.

``take`` and ``take2d`` launch the kernel on CUDA tensors (or raise); CPU
tensors take the plain versions ``take_plain`` and ``take2d_plain``, which
are also what ``chip_smoke.py`` holds the kernels against on the card.

Each kernel takes one index a thread. Wider designs and a table held in a
cluster's distributed shared memory were no faster at the probes' shapes
(``tools/gather_sweep.py``; the source note of ``csrc/gather.cu``).
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import cuda_build

LANES = 128  # words in a row of the 2D table


def take_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return table[idx.long()]


def take2d_plain(table2d: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    idx = idx.long()
    return table2d[idx >> 7, idx & (LANES - 1)]


def _check(table: torch.Tensor, idx: torch.Tensor, ndim: int) -> None:
    if table.dim() != ndim or idx.dim() != 1:
        raise ValueError(f"expected a {ndim}-D table and 1-D indices, got "
                         f"{tuple(table.shape)} and {tuple(idx.shape)}")
    if ndim == 2 and table.shape[1] != LANES:
        raise ValueError(f"the 2D table has rows of {LANES} words, got "
                         f"{table.shape[1]}")
    for t in (table, idx):
        if not t.is_cuda or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("the gather kernels take contiguous int32 CUDA "
                             "tensors")
    if table.device != idx.device:
        raise ValueError("table and idx lie on different devices")


def _lib():
    lib = cuda_build.load("gather")
    for fn in (lib.dgr_take, lib.dgr_take2d):
        if fn.argtypes is None:  # argtypes last: set means all set
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_void_p, ctypes.c_void_p]
    return lib


def _launch(name: str, table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    out = torch.empty(idx.shape, dtype=torch.int32, device=idx.device)
    if idx.numel() == 0:
        return out
    with torch.cuda.device(idx.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(_lib(), name)(table.data_ptr(), idx.data_ptr(),
                                    idx.numel(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return out


def take_cuda(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Launch the flat gather kernel on the current stream."""
    _check(table, idx, 1)
    out = _launch("dgr_take", table, idx)
    cuda_build.count_launch(take_cuda)
    return out


def take2d_cuda(table2d: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Launch the row-then-lane gather kernel on the current stream."""
    _check(table2d, idx, 2)
    out = _launch("dgr_take2d", table2d, idx)
    cuda_build.count_launch(take2d_cuda)
    return out


take_cuda.launches = 0
take2d_cuda.launches = 0


def take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table [W] int32, idx [N] int32 in [0, W) -> table[idx] [N] int32."""
    if table.is_cuda or idx.is_cuda:
        return take_cuda(table, idx)
    return take_plain(table, idx)


def take2d(table2d: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table2d [W / 128, 128] int32, idx [N] int32 in [0, W) ->
    table2d[idx >> 7, idx & 127] [N] int32."""
    if table2d.is_cuda or idx.is_cuda:
        return take2d_cuda(table2d, idx)
    return take2d_plain(table2d, idx)
